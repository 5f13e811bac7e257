"""Entry points: the batched sampler's forward step and the multi-device
dry runs.

Port of the JAX package's ``__graft_entry__.py``.

``entry(device=None)`` returns ``(fn, example_args)``: one call of ``fn``
is two thinned blocks of the 'collapsed' engine's batched segment
(``sampler.batch._segment``, the counterpart of the JAX ``xla`` engine)
at B = 8 lanes, V = 256 values, K = 15.

``dryrun_multichip(n, device=None)`` runs six legs over an n-device mesh
at fixed toy sizes, each with its asserts: the event-sharded sampling
step, the fused kernels under lane sharding (an unpacked bucket, K2), a
packed bucket and a mixed-width bucket (K3), sharded post-processing, and
frame-sharded contacts and densities against their unsharded runs. The
mesh takes the visible cards, or repeats one device where fewer are
visible (``make_mesh(devices=[device] * n)``).

``dryrun_multihost(device=None)`` runs two processes on localhost joined
in a gloo group (``parallel.distributed``), which split five residues and
write disjoint subtrees of one results tree.

Everything runs on the card unless given ``device='cpu'``, where the
kernels' plain versions run.

    python -m basicrta_torch.entry [--device cpu] [--devices N]
"""

import os

import numpy as np


def _example_batch(B, V, K, seed=0):
    rng = np.random.default_rng(seed)
    # counts sorted descending to satisfy the tiered sampler's layout
    counts = np.sort(rng.integers(0, 1000, (B, V)))[:, ::-1].astype(
        np.float64)
    counts[:, V // 2:] = np.maximum(
        counts[:, V // 2:] * 0, rng.integers(0, 2, (B, V - V // 2)))
    values = 0.1 * rng.integers(1, 5000, (B, V)).astype(np.float64)
    return values, counts


def _device(device):
    """The run's device: the card by default (raises without one)."""
    from basicrta_torch.sampler.batch import resolve_engine
    return resolve_engine("collapsed", device)[1]


def entry(device=None):
    """(fn, example_args): ``fn(generator, state, values, counts)`` ->
    (state, W, R), two thinned blocks (g = 10) of the collapsed engine's
    batched segment over 8 lanes of 256 values, K = 15."""
    import torch

    from basicrta_torch.config import GibbsConfig
    from basicrta_torch.ops.random import seeded_generator
    from basicrta_torch.sampler.batch import _segment
    from basicrta_torch.sampler.kernels import (MixtureState, compute_tiers,
                                                init_mixture_params)

    device = _device(device)
    cfg = GibbsConfig(ncomp=15, niter=100, g=10)
    B, V = 8, 256
    values, counts = _example_batch(B, V, cfg.ncomp)
    order, tiers = compute_tiers(counts)
    values = np.take_along_axis(values, order, axis=-1)
    counts = np.take_along_axis(counts, order, axis=-1)

    st0 = init_mixture_params(cfg.ncomp)
    state = MixtureState(st0.weights.repeat(B, 1).to(device),
                         st0.rates.repeat(B, 1).to(device))

    def fn(generator, state, values, counts):
        return _segment(generator, state, values, counts, cfg, 2, tiers)

    example_args = (seeded_generator(device, 0), state,
                    torch.as_tensor(values, dtype=torch.float32,
                                    device=device),
                    torch.as_tensor(counts, dtype=torch.float32,
                                    device=device))
    return fn, example_args


def _mesh_devices(n, device):
    """n devices of ``device``'s kind: the visible cards, or ``device``
    repeated where fewer are visible."""
    import torch
    if device.type == "cuda" and torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [device] * n


def dryrun_multichip(n_devices: int, device=None, out=print) -> None:
    """The six legs over an ``n_devices`` mesh on tiny shapes; each
    asserts its result."""
    import torch

    from basicrta_torch.config import GibbsConfig
    from basicrta_torch.parallel.mesh import (lane_sharding, make_mesh,
                                              sharded_training_step)
    from basicrta_torch.sampler.kernels import (MixtureState,
                                                init_mixture_params)

    device = _device(device)
    devices = _mesh_devices(n_devices, device)

    # 1. the event-sharded sampling step: lanes over 'lanes', values over
    # 'events' with the statistics summed each sweep
    n_events = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(n_lanes=n_devices // n_events, n_events=n_events,
                     devices=devices)
    cfg = GibbsConfig(ncomp=5, niter=20, g=10)
    B = 2 * (n_devices // n_events)
    V = 64 * n_events
    values, counts = _example_batch(B, V, cfg.ncomp, seed=1)
    st0 = init_mixture_params(cfg.ncomp)
    state = MixtureState(st0.weights.repeat(B, 1).to(device),
                         st0.rates.repeat(B, 1).to(device))
    step = sharded_training_step(mesh, cfg, n_blocks=2)
    st, W, R = step(0, state,
                    torch.as_tensor(values, dtype=torch.float32,
                                    device=device),
                    torch.as_tensor(counts, dtype=torch.float32,
                                    device=device))
    w = W.cpu().numpy()
    assert w.shape == (B, 2, cfg.ncomp)
    assert np.all(np.isfinite(w)) and np.allclose(
        st.weights.sum(-1).cpu().numpy(), 1.0, atol=1e-4)
    out(f"dryrun_multichip OK: mesh {mesh.shape}, W={w.shape}")

    # 2. the fused kernels under lane sharding (an unpacked bucket: K2),
    # driven through the run_batch the CLI and ParallelGibbs use
    from basicrta_torch.sampler.batch import bucket_residues, run_batch
    rng = np.random.default_rng(2)
    lanes_mesh = make_mesh(n_lanes=n_devices, n_events=1, devices=devices)
    lanes = lane_sharding(lanes_mesh)
    residues = {f"R{i}": 0.1 * rng.integers(1, 200, 400)
                for i in range(n_devices - 1)}
    batch = bucket_residues(residues, floor=128)[0]
    res = run_batch(batch, cfg, sharding=lanes)
    assert res.mcweights.shape[0] == n_devices - 1
    assert np.all(np.isfinite(res.mcweights))
    out(f"dryrun_multichip fused OK: mesh {lanes_mesh.shape}, "
        f"W={res.mcweights.shape}")

    # 3. a packed small-residue bucket (8 logical lanes per 128-column
    # physical lane: K3). Sizes are fixed, not scaled by n_devices: the
    # cost-model layout adopts packing above a member count only
    n_small = max(16, 2 * n_devices)
    small = {f"S{i}": 0.2 * rng.integers(1, 13, 300)
             for i in range(n_small)}
    pbatch = bucket_residues(small, consolidate=False)[0]
    assert pbatch.pack > 1, pbatch.values.shape
    res_p = run_batch(pbatch, cfg, sharding=lanes)
    assert res_p.mcweights.shape[0] == n_small
    assert np.all(np.isfinite(res_p.mcweights))
    out(f"dryrun_multichip packed OK: pack={pbatch.pack}, "
        f"W={res_p.mcweights.shape}")

    # 4. a mixed-width packed bucket (per-physical-lane widths, the
    # seg_mask operand) under lane sharding
    n_het = max(16, 2 * n_devices)
    hetero = {f"M{i}": 0.1 * rng.integers(1, 60 + 200 * (i % 2), 800)
              for i in range(n_het)}
    mbatch = bucket_residues(hetero)[0]
    assert mbatch.bounds is not None, (mbatch.values.shape, mbatch.pack)
    res_m = run_batch(mbatch, cfg, sharding=lanes)
    assert res_m.mcweights.shape[0] == n_het
    assert np.all(np.isfinite(res_m.mcweights))
    out(f"dryrun_multichip mixed OK: rows={mbatch.phys_rows}, "
        f"W={res_m.mcweights.shape}")

    # 5. sharded post-processing over the lanes mesh
    from basicrta_torch.postprocess.batched import process_residues_batched
    from basicrta_torch.sampler.kernels import dedup_times
    pcfg = GibbsConfig(ncomp=5, niter=20, g=10, burnin=10, gmm_n_init=4)
    items = {}
    for i, name in enumerate(res.names):
        v, c = dedup_times(residues[name])
        items[name] = (res.mcweights[i][None], res.mcrates[i][None], v, c)
    post = process_residues_batched(items, pcfg, sharding=lanes)
    assert set(post) == set(items)
    assert all(np.all(np.isfinite(r.pindicator_values))
               for r in post.values())
    out(f"dryrun_multichip postprocess OK: {len(post)} residues sharded "
        f"over {n_devices} devices")

    # 6. frame-sharded contacts and densities: rows and grids equal to
    # the unsharded runs
    from basicrta_torch.config import ContactConfig
    from basicrta_torch.contacts.mapper import FrameBatch, MapContacts
    from basicrta_torch.contacts.records import ContactMeta
    from basicrta_torch.kinetics.density import GridAccumulator
    R1, P1, R2, P2, F = 4, 3, 5, 4, 12
    box = np.array([40.0, 40.0, 40.0], np.float32)
    pos = rng.uniform(0, 40, (2 * F, R1 * P1 + R2 * P2, 3)).astype(
        np.float32)
    cbatches = [FrameBatch(np.arange(lo, lo + F),
                           np.arange(lo, lo + F) * 0.1,
                           pos[lo:lo + F], box=np.tile(box, (F, 1)))
                for lo in (0, F)]
    kw = dict(indices1=np.arange(R1 * P1),
              resids1=np.repeat(np.arange(R1), P1),
              indices2=np.arange(R1 * P1, R1 * P1 + R2 * P2),
              resids2=np.repeat(np.arange(R2) + 100, P2),
              cfg=ContactConfig(), meta=ContactMeta(ts=0.1))
    rec_sh = MapContacts(devices=devices, **kw).run(cbatches)
    rec_ref = MapContacts(device=device, **kw).run(cbatches)
    assert np.array_equal(rec_sh.frames, rec_ref.frames)
    assert np.array_equal(rec_sh.min_dist, rec_ref.min_dist)
    out(f"dryrun_multichip contacts OK: {len(rec_sh)} rows frame-sharded "
        f"over {n_devices} devices == unsharded")
    Kd, Fd, Ad = 3, 4 * n_devices + 3, 17    # odd F exercises padding
    dpos = rng.uniform(0, 40, (Fd, Ad, 3)).astype(np.float32)
    dw = rng.random((Fd, Kd)).astype(np.float32)
    dmask = (rng.random((Fd, Ad)) < 0.9).astype(np.float32)
    acc_ref = GridAccumulator(Kd, gridcenter=[20.0, 20.0, 20.0],
                              device=device)
    acc_ref.add(dpos, dw, mask=dmask)
    acc_sh = GridAccumulator(Kd, gridcenter=[20.0, 20.0, 20.0],
                             mesh=lanes_mesh)
    acc_sh.add(dpos, dw, mask=dmask)
    g_sh, g_ref = acc_sh.finish()[0], acc_ref.finish()[0]
    assert np.allclose(g_sh, g_ref, atol=1e-4), np.abs(g_sh - g_ref).max()
    assert g_ref.sum() > 0
    out(f"dryrun_multichip density OK: {Fd} frames sharded over "
        f"{n_devices} devices == unsharded (K={Kd} grids)")


_MULTIHOST_WORKER = r"""
import sys
import numpy as np
rank, tree, port, device = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                            sys.argv[4])
from basicrta_torch.parallel.distributed import (host_residue_partition,
                                                 initialize, is_multihost)
initialize(f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
assert is_multihost()
mine = host_residue_partition([f"X{i}" for i in range(5)])
from basicrta_torch.config import GibbsConfig
from basicrta_torch.sampler.gibbs import Gibbs
rng = np.random.default_rng(rank)
for lab in mine:
    x = 0.1 * rng.integers(1, 50, 200)
    g = Gibbs(x, residue=lab, cutoff=7.0,
              cfg=GibbsConfig(ncomp=3, niter=40, g=10, burnin=10),
              root=tree)
    g.run(device=device)
print(f"host {rank} sampled {mine}", flush=True)
"""


def dryrun_multihost(device=None, out=print) -> None:
    """Two processes on localhost join one gloo group through
    ``parallel.distributed.initialize``, split five residues with
    ``host_residue_partition`` and write disjoint subtrees of one
    ``basicrta-{cutoff}/`` results tree (the reference's Slurm-array
    shape)."""
    import socket
    import subprocess
    import sys
    import tempfile

    device = _device(device)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [repo] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    with tempfile.TemporaryDirectory() as tree:
        procs = [subprocess.Popen(
            [sys.executable, "-c", _MULTIHOST_WORKER, str(i), tree,
             str(port), str(device)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for i in (0, 1)]
        try:
            outs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        for p, o in zip(procs, outs):
            assert p.returncode == 0, f"multihost worker failed:\n{o}"
        done = sorted(d for d in os.listdir(os.path.join(tree,
                                                         "basicrta-7.0"))
                      if not d.startswith("."))
        assert done == [f"X{i}" for i in range(5)], done
        for d in done:
            assert os.path.exists(
                os.path.join(tree, "basicrta-7.0", d, "gibbs_40.npz"))
    out("dryrun_multihost OK: 2 hosts partitioned 5 residues into a "
        "shared results tree")


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="the card (the default; raises without one) or "
                         "the CPU")
    ap.add_argument("--devices", type=int, default=8,
                    help="mesh size of the multi-device dry run")
    args = ap.parse_args(argv)
    fn, example = entry(args.device)
    st, W, R = fn(*example)
    assert W.shape == (8, 2, 15) and bool(W.isfinite().all())
    print("entry OK")
    dryrun_multichip(args.devices, args.device)
    dryrun_multihost(args.device)


if __name__ == "__main__":
    main()
