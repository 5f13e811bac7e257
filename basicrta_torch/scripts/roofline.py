"""The transcendental ceiling of the card (K6) and the sampler roofline.

Counterpart of ``bench.py``'s ``transcendental_ceiling`` and of its
``vpu_transcendental_util`` extra (the name is kept so that the metric
reads the same in both packages):

- :func:`ceiling_tile` — the kernel (``csrc/ceiling.cu``): 64 independent
  chains per element of a (256, 128) f32 tile, ``iters`` steps of
  x <- exp(x * scale), summed in chain order; :func:`ceiling_tile_torch`
  is its plain version (a loop of ``torch.exp``). bench.py's scale 1e-9
  sends every chain to 1.0 at its first step, so the kernel is checked
  at ``CHECK_SCALE`` = -1, where each step still moves the result.
- :func:`transcendental_ceiling` — exps per second of that kernel on the
  card at bench.py's scale: best of 3 blocks of 5 launches, timed with
  CUDA events.
- :func:`vpu_transcendental_util` — the sweep kernels' static
  transcendental count per sweep (``cuda_sweep.transcendentals_per_sweep``)
  times the aggregate lane-sweeps/s, per lane, over the ceiling.
- :func:`needed_transcendentals` — a lower bound on what one sweep of a
  bucket must compute on the card, for the sweep kernels' bounds.
- :func:`prng_bound` — the same for a launch of the PRNG probe (K5): the
  larger of the bytes it writes over the memory rate and its samplers'
  transcendentals over the measured ceiling.

Run on the card: ``python -m basicrta_torch.scripts.roofline`` prints the
ceiling in ops/s beside the SFU's peak at the card's clock.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from typing import Optional, Sequence

import torch

from basicrta_torch.sampler import batch as _batch
from basicrta_torch.sampler import cuda_sweep

ITERS, TILES, ROWS, COLS = 2000, 64, 256, 128
SCALE = 1e-9                # bench.py's step: x <- exp(x * 1e-9)
CHECK_SCALE = -1.0          # a contraction that does not saturate at 1.0
GAMMA_FLOOR = 3             # sqrt, log and exp every gamma draw computes
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
SMS = 132                   # streaming multiprocessors of an H100 SXM
MUFU_PER_CLOCK = 16         # SFU exp2 results per clock per SM (Hopper)
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(cuda_sweep.build_library(source="ceiling.cu"))
        lib.basicrta_transcendental_ceiling.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        lib.basicrta_transcendental_ceiling.restype = ctypes.c_int
        _lib = lib
    return _lib


def ceiling_tile_torch(iters: int = ITERS, tiles: int = TILES,
                       device="cpu", scale: float = SCALE) -> torch.Tensor:
    """Plain version of the ceiling kernel: ``tiles`` (256, 128) f32 chains
    started at 0.5 + 0.1 t, ``iters`` steps of exp(x * scale), summed in
    chain order into one (256, 128) tile."""
    x = torch.stack([torch.full((ROWS, COLS), 0.5 + 0.1 * t,
                                dtype=torch.float32, device=device)
                     for t in range(tiles)])
    for _ in range(iters):
        x = torch.exp(x * scale)
    acc = x[0]
    for t in range(1, tiles):
        acc = acc + x[t]
    return acc


def ceiling_tile(out: torch.Tensor, iters: int = ITERS,
                 scale: float = SCALE) -> torch.Tensor:
    """K6 into ``out``, a (256, 128) f32 tile: a CPU tile takes the plain
    version, a CUDA tile launches the kernel."""
    if tuple(out.shape) != (ROWS, COLS) or out.dtype != torch.float32:
        raise ValueError(f"the ceiling writes a ({ROWS}, {COLS}) float32 "
                         f"tile; got {tuple(out.shape)} {out.dtype}")
    if out.device.type == "cpu":
        out.copy_(ceiling_tile_torch(iters, TILES, scale=scale))
        return out
    if not out.is_contiguous():
        raise ValueError("the ceiling tile must be contiguous")
    stream = torch.cuda.current_stream(out.device).cuda_stream
    rc = _library().basicrta_transcendental_ceiling(
        out.data_ptr(), int(iters), float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"transcendental_ceiling kernel launch failed: "
                           f"CUDA error {rc}")
    ceiling_tile.launches += 1
    return out


ceiling_tile.launches = 0


def _best_seconds(fn, device, blocks: int = 3, reps: int = 5) -> float:
    """Best mean seconds per call of ``fn`` over ``blocks`` blocks of
    ``reps`` calls, by CUDA events after one warm-up call."""
    if torch.device(device).type != "cuda":
        raise RuntimeError("the ceiling is a device measurement: it needs a "
                           "CUDA device")
    fn()
    torch.cuda.synchronize(device)
    best = float("inf")
    for _ in range(blocks):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        best = min(best, start.elapsed_time(end) / 1e3 / reps)
    return best


def ceiling_ops() -> int:
    """exps one ceiling call executes."""
    return ITERS * TILES * ROWS * COLS


def transcendental_ceiling(device="cuda") -> float:
    """Measured exp throughput of the card [ops/s]: the ceiling kernel,
    best of 3 blocks of 5 launches."""
    out = torch.empty((ROWS, COLS), dtype=torch.float32, device=device)
    return ceiling_ops() / _best_seconds(lambda: ceiling_tile(out), device)


def transcendental_ceiling_torch(device="cuda") -> float:
    """The same measurement of the plain version on the card [ops/s]."""
    return ceiling_ops() / _best_seconds(
        lambda: ceiling_tile_torch(device=device), device, blocks=1, reps=1)


def sfu_peak(clock_mhz: float) -> float:
    """The card's exp2 peak [ops/s] at an SM clock of ``clock_mhz``."""
    return MUFU_PER_CLOCK * SMS * clock_mhz * 1e6


def max_sm_clock_mhz() -> float:
    """The card's maximum SM clock, as ``nvidia-smi`` reports it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.split()[0])


def needed_transcendentals(counts, lanes: int, K: int,
                           conjugate: bool = True) -> int:
    """A lower bound on the exp/log/sqrt one sweep of a bucket must compute
    on the card: K exps per non-empty column of ``counts`` (the suffix
    sums) and, with the conjugate draw, 2K gammas per real lane of
    ``GAMMA_FLOOR`` each. Padded lanes and columns are not counted, nor
    the binomial and rejection rounds, whose number depends on the draws
    (unlike :func:`~basicrta_torch.sampler.cuda_sweep.
    transcendentals_per_sweep`, the reference layout's static count)."""
    cols = int((counts > 0).sum())
    return K * cols + (2 * K * lanes * GAMMA_FLOOR if conjugate else 0)


def prng_transcendentals_per_draw(kind: str, n: float = 0.0, p: float = 0.0,
                                  a: float = 0.0) -> float:
    """A lower bound on the sqrt/log/exp one draw of the PRNG probe must
    compute, counted as :func:`needed_transcendentals` counts a sweep's:
    the set-up every draw computes plus ONE rejection round (the expected
    number of rounds is above one; a bound takes the least).

    - ``uniform``: none (hashes only).
    - ``binom_*`` above n p = 10 (BTRS): sqrt(n p q) and the mode's terms
      (``binom_h4``: one log; ``binom_lgamma``: one log and two log-gammas
      of at least one log each), then a round whose accept test costs
      three logs unless the squeeze takes it: the squeeze holds with
      probability 0.86 v_r (|u| <= 0.43 and v <= v_r, independent
      uniforms). At or below n p = 10 (inversion): exp and log of q^n.
    - ``gamma``: ``GAMMA_FLOOR`` (sqrt, and the two logs of a round's
      accept test), plus the boost's log and exp below a = 1.
    """
    if kind == "uniform":
        return 0.0
    if kind == "gamma":
        return GAMMA_FLOOR + (2.0 if a < 1.0 else 0.0)
    if kind not in ("binom_lgamma", "binom_h4"):
        raise ValueError(f"unknown draw kind {kind!r}")
    pe = min(p, 1.0 - p)
    if n * pe <= 10.0:
        return 2.0
    b = 1.15 + 2.53 * (n * pe * (1.0 - pe)) ** 0.5
    vr = 0.92 - 4.2 / b
    setup = 2.0 if kind == "binom_h4" else 4.0
    return setup + 3.0 * (1.0 - 0.86 * vr)


def prng_bound(kind: str, draws: int, ceiling: float, n: float = 0.0,
               p: float = 0.0, a: float = 0.0):
    """The least milliseconds the card could take for ``draws`` f32 draws
    of ``kind``: the larger of the bytes written over the memory rate and
    the transcendentals needed over the measured exp ``ceiling``. Returns
    (ms, 'bytes' | 'operations', transcendentals a draw)."""
    per_draw = prng_transcendentals_per_draw(kind, n, p, a)
    t_bytes = 4 * draws / HBM_BYTES_PER_S
    t_ops = per_draw * draws / ceiling
    return (1e3 * max(t_bytes, t_ops),
            "operations" if t_ops >= t_bytes else "bytes", per_draw)


def _phys(b) -> Optional[tuple]:
    """A mixed bucket's (SL, head_rows, small_rows, Bph) physical layout,
    as bench.py's roofline takes it; None for the others."""
    if b.bounds is None:
        return None
    tiers = _batch._kernel_layout(b)[2]
    return (b.phys_rows, *tiers, len(b.bounds))


def transcendentals(batches: Sequence, K: int) -> int:
    """The static transcendental count of one sweep of every bucket."""
    return sum(cuda_sweep.transcendentals_per_sweep(
        b.size, b.values.shape[1], b.pack, b.tiers, K, phys=_phys(b))
        for b in batches)


def vpu_transcendental_util(batches: Sequence, agg: float, cfg,
                            ceiling: Optional[float] = None) -> float:
    """bench.py's roofline: the buckets' transcendentals per sweep x the
    aggregate lane-sweeps/s ``agg`` / lanes, over the measured ceiling
    (measured here when not given)."""
    if ceiling is None:
        ceiling = transcendental_ceiling()
    achieved = transcendentals(batches, cfg.ncomp) * agg / sum(
        b.size for b in batches)
    return achieved / ceiling


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("roofline: no CUDA device", file=sys.stderr)
        return 1
    peak = sfu_peak(max_sm_clock_mhz())
    print(f"SFU exp peak {peak:.6g}/s on {torch.cuda.get_device_name(0)}")
    ceiling = transcendental_ceiling()
    print(f"transcendental ceiling: {ceiling:.6g} exp/s "
          f"({ceiling / peak:.4f} of the peak)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
