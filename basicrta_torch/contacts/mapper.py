"""Contact-map extraction driver (MapContacts / ProcessContacts parity).

Port of ``basicrta_tpu.contacts.mapper``. The reference forks a process
pool over trajectory slices, each worker running a C neighbour search per
frame and writing text shards that the parent re-parses into a memmap
(reference contacts.py:57-132). Here frame batches stream through the
distance kernel on the card and sparse rows accumulate in memory; there is
no text round-trip and no fork.

The trajectory source is any iterable of ``FrameBatch``: the readers of
``basicrta_torch.io`` (XTC/TRR/DCD/...) or synthetic generators in tests.

Per batch the host lays the selections out by residue (and quantizes to
the u16 wire format when asked) into a pinned staging buffer, a copy
stream uploads it, the compute stream waits on the copy's event and runs
the distance kernel and the compaction as eager torch ops, and one pinned
device-to-host copy brings (count, pair index, distance) back. A prefetch
thread prepares batch i + 1 while the card computes batch i and the main
thread decodes batch i - 1.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
import time
from typing import Iterable, Optional

import numpy as np
import torch

from basicrta_torch.config import ContactConfig
from basicrta_torch.contacts.distances import (compact_contacts,
                                               contacts_from_batch,
                                               group_by_residue,
                                               min_dist_per_residue_pair,
                                               min_dist_pruned)
from basicrta_torch.contacts.events import merge_events
from basicrta_torch.contacts.quantize import quantize_u16
from basicrta_torch.contacts.records import (ContactEvents, ContactMeta,
                                             ContactRecords, FrameBatch)

__all__ = ["FrameBatch", "MapContacts", "ProcessContacts"]

# checkpoints of a scan carry this tag in their fingerprint, so one written
# by the JAX package is refused, never resumed across packages
_ENGINE_TAG = b"basicrta_torch-contacts"
_TORCH_DTYPE = {np.float32: torch.float32, np.int16: torch.int16}

_COLUMN_SPEC = (("frames", np.int64), ("s1", np.int32), ("s2", np.int32),
                ("dist", np.float32), ("times", np.float64))


class _ColumnStore:
    """Contact-row accumulator with a host-memory valve.

    Rows accumulate in RAM lists; past ``budget_rows`` they spill to
    anonymous on-disk files that finalize as ``np.memmap`` columns — the
    reference streams shards into a disk memmap with ``nslices`` as the
    explicit memory valve (contacts.py:45-48,86-92); this is the same
    valve without the text round-trip. Spill files are unlinked immediately
    after mapping, so nothing is left behind on any exit path.
    """

    def __init__(self, budget_rows: int = 0,
                 spill_dir: Optional[str] = None):
        self.budget = int(budget_rows)
        self.spill_dir = spill_dir
        self.lists = {k: [] for k, _ in _COLUMN_SPEC}
        self.ram_rows = 0
        self.total_rows = 0
        self.spilled = False
        self._files = {}

    def append(self, frames, s1, s2, dist, times):
        for (k, dt), col in zip(_COLUMN_SPEC,
                                (frames, s1, s2, dist, times)):
            self.lists[k].append(np.asarray(col, dt))
        self.ram_rows += len(frames)
        self.total_rows += len(frames)
        if self.budget and self.ram_rows > self.budget:
            self._flush()

    def _flush(self):
        if not self._files:
            for k, dt in _COLUMN_SPEC:
                fd, path = tempfile.mkstemp(prefix=f".contacts_{k}_",
                                            suffix=".bin",
                                            dir=self.spill_dir)
                self._files[k] = (os.fdopen(fd, "wb"), path)
        for k, dt in _COLUMN_SPEC:
            for arr in self.lists[k]:
                self._files[k][0].write(
                    np.ascontiguousarray(arr, dt).tobytes())
            self.lists[k].clear()
        self.ram_rows = 0
        self.spilled = True

    def finalize(self):
        """Return the concatenated columns; memmap-backed when spilled."""
        if not self._files:
            return {k: (np.concatenate(v) if v
                        else np.zeros(0, dict(_COLUMN_SPEC)[k]))
                    for k, v in self.lists.items()}
        self._flush()
        out = {}
        for k, dt in _COLUMN_SPEC:
            f, path = self._files[k]
            f.close()
            if self.total_rows:
                out[k] = np.memmap(path, dtype=dt, mode="r",
                                   shape=(self.total_rows,))
            else:
                out[k] = np.zeros(0, dt)
            os.unlink(path)   # mapping stays valid; leaves no file behind
        self._files.clear()
        return out


class _Checkpointer:
    """Durable mid-scan checkpoints for :meth:`MapContacts.run`.

    Contact rows accumulate into append-only ``shard_{k:06d}.npz`` files
    under the checkpoint directory with an atomically-replaced
    ``state.json`` recording the next unprocessed frame, so a preempted
    trajectory scan resumes where the last checkpoint left off instead of
    frame 0 (the reference restarts contact extraction from scratch — its
    worker shards are per-run temporaries, reference contacts.py:86-98).
    The state carries a fingerprint of the selections/config; resuming
    with different inputs is refused. The directory is removed by the
    caller (``MapContacts.remove_checkpoint``) once the records artifact
    is durably saved.
    """

    STATE = "state.json"

    # rows pending in RAM between flushes are capped independently of the
    # frame interval, so dense systems don't re-create the host-memory
    # problem _ColumnStore's valve solves (an early flush just writes a
    # smaller shard; the state stays consistent)
    PENDING_ROW_BUDGET = 4_000_000

    def __init__(self, ckpt_dir: str, fingerprint: str, every: int):
        self.dir = ckpt_dir
        self.fp = fingerprint
        self.every = max(int(every), 1)
        self.pending = {k: [] for k, _ in _COLUMN_SPEC}
        self.pending_diffs: list = []
        self.pending_rows = 0
        self.n_shards = 0
        self.next_frame = 0
        self.last_time = None
        self._last_ckpt_frame = 0

    def load(self):
        """Restore prior progress; (columns, diffs, last_time, next_frame)
        or None when starting fresh."""
        path = os.path.join(self.dir, self.STATE)
        if not os.path.exists(path):
            os.makedirs(self.dir, exist_ok=True)
            return None
        with open(path) as fh:
            state = json.load(fh)
        if state["fingerprint"] != self.fp:
            raise ValueError(
                f"checkpoint {self.dir} was written by a run with "
                "different selections/cutoff/trajectory/--dt; remove "
                f"that directory (or pass a different checkpoint_dir) "
                "to start the scan over")
        cols = {k: [] for k, _ in _COLUMN_SPEC}
        diffs = []
        for i in range(state["shards"]):
            with np.load(os.path.join(self.dir,
                                      f"shard_{i:06d}.npz")) as z:
                for k, _ in _COLUMN_SPEC:
                    cols[k].append(z[k])
                diffs.append(z["diffs"])
        self.n_shards = state["shards"]
        self.next_frame = int(state["next_frame"])
        self.last_time = state["last_time"]
        self._last_ckpt_frame = self.next_frame
        out = {k: (np.concatenate(v) if v else np.zeros(0, dt))
               for (k, dt), v in zip(_COLUMN_SPEC, cols.values())}
        d = (np.concatenate(diffs) if diffs else np.zeros(0))
        return out, d, self.last_time, self.next_frame

    def add(self, rows, new_diffs, next_frame: int, last_time):
        for (k, dt), col in zip(_COLUMN_SPEC, rows):
            self.pending[k].append(np.asarray(col, dt))
        self.pending_rows += len(rows[0])
        self.pending_diffs.extend(np.atleast_1d(d) for d in new_diffs)
        self.next_frame = int(next_frame)
        self.last_time = last_time
        if (self.next_frame - self._last_ckpt_frame >= self.every
                or self.pending_rows >= self.PENDING_ROW_BUDGET):
            self.flush()

    def flush(self):
        if self.next_frame == self._last_ckpt_frame:
            return
        payload = {k: (np.concatenate(v) if v else np.zeros(0, dt))
                   for (k, dt), v in zip(_COLUMN_SPEC,
                                         self.pending.values())}
        payload["diffs"] = (np.concatenate(self.pending_diffs)
                            if self.pending_diffs
                            else np.zeros(0, np.float64))
        shard = os.path.join(self.dir, f"shard_{self.n_shards:06d}.npz")
        tmp = shard + ".tmp"
        with open(tmp, "wb") as fh:
            np.savez(fh, **payload)
        os.replace(tmp, shard)   # shard first, then the state naming it:
        self.n_shards += 1       # a crash in between leaves an orphan
        for v in self.pending.values():
            v.clear()
        self.pending_diffs.clear()
        self.pending_rows = 0
        self._write_state()
        self._last_ckpt_frame = self.next_frame

    def _write_state(self):
        path = os.path.join(self.dir, self.STATE)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump({"fingerprint": self.fp, "shards": self.n_shards,
                       "next_frame": self.next_frame,
                       "last_time": self.last_time}, fh)
        os.replace(tmp, path)


def _resolve_device(device) -> torch.device:
    """The device of a scan: the card unless the caller names another;
    nothing falls back to the CPU because no GPU was found."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the contact scan runs on a CUDA device and none "
                           "is available; pass device='cpu' (CLI: --device "
                           "cpu) for the CPU")
    return device


class _HostCopy:
    """A device result on its way to the host: one pinned buffer, one
    non-blocking copy and an event to wait on for each of its frame
    shards (a list of tensors, one a device, concatenated on arrival)."""

    def __init__(self, t):
        self._parts = []
        for part in (t if isinstance(t, list) else [t]):
            if part.device.type == "cpu":
                self._parts.append((part, None))
                continue
            with torch.cuda.device(part.device):
                host = torch.empty(part.shape, dtype=part.dtype,
                                   pin_memory=True)
                host.copy_(part, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            self._parts.append((host, event))

    def numpy(self) -> np.ndarray:
        for _, event in self._parts:
            if event is not None:
                event.synchronize()
        if len(self._parts) == 1:
            return self._parts[0][0].numpy()
        return np.concatenate([host.numpy() for host, _ in self._parts])


@dataclasses.dataclass
class _FrameShards:
    """A batch prepared as frame shards: each shard's upload (as
    ``MapContacts._prepare_on`` returns it) and its count of real frames
    (the last shard's padding frames are cut off its results)."""
    preps: list
    real: list


class MapContacts:
    """Compute the primary contact map between two atom groups.

    :param indices1/indices2: atom indices of the two groups (the reference's
        ag1/ag2 AtomGroups, contacts.py:53-55).
    :param resids1/resids2: per-atom residue ids for each group.
    :param cfg: ContactConfig (map cutoff default 10.0 A, contacts.py:51).
    :param device: where the distance kernel runs: the card by default
        (raises without one), ``"cpu"`` on request.
    :param n_devices: shard each batch's frames over this many devices of
        ``device``'s kind (0: every visible card; None: unsharded). The
        frame axis is padded to the shard count with the last frame, every
        shard runs the scan on its device, and the padding rows never
        leave it: the rows are the unsharded scan's.
    :param devices: an explicit list of the shards' devices in place of
        ``n_devices``; it may repeat a device (several shards on one).

    After :meth:`run`, ``stats`` holds what the scan did: frames, batches,
    device passes by mode, exact-fit retries and dense fallbacks of the
    pruned path, dense-transfer overflows, the host's prepare seconds (the
    prefetch thread), its collect seconds (waiting for the card's result
    and decoding it into rows) and, with ``time_device = True``, the
    device's seconds by CUDA events.
    """

    def __init__(self, indices1: np.ndarray, resids1: np.ndarray,
                 indices2: np.ndarray, resids2: np.ndarray,
                 cfg: ContactConfig = ContactConfig(),
                 meta: Optional[ContactMeta] = None, device=None,
                 n_devices: Optional[int] = None, devices=None):
        if devices is not None:
            devices = [torch.device(d) for d in devices]
            device = devices[0]
        self.device = _resolve_device(device)
        self.devices = devices or [self.device]
        if n_devices is not None:
            from basicrta_torch.parallel.mesh import local_devices
            self.devices = local_devices(n_devices or None, self.device)
            self.device = self.devices[0]
        self.indices1 = np.asarray(indices1)
        self.indices2 = np.asarray(indices2)
        self.cfg = cfg
        self.meta = meta or ContactMeta()
        self.group_idx1, self.uniq_resids1 = group_by_residue(
            np.asarray(resids1))
        self.group_idx2, self.uniq_resids2 = group_by_residue(
            np.asarray(resids2))
        # host-side residue-padded upload layout: the host lays each frame
        # out as (R1*P1 + R2*P2, 3) with atoms grouped by residue, so the
        # device pass is a pure reshape and nothing but coordinates
        # crosses to the card per batch (a gather on the card instead is
        # not measured). Pad slots replicate the group's first atom and
        # are masked out of every distance min.
        gi1, gi2 = self.group_idx1, self.group_idx2
        lay1 = self.indices1[np.where(gi1 < 0, 0, gi1)].ravel()
        lay2 = self.indices2[np.where(gi2 < 0, 0, gi2)].ravel()
        self._host_layout = np.concatenate([lay1, lay2])
        # no mask at all when every slot is an atom (uniform residues)
        self._mask1 = (None if (gi1 >= 0).all()
                       else torch.as_tensor(gi1 >= 0, device=self.device))
        self._mask2 = (None if (gi2 >= 0).all()
                       else torch.as_tensor(gi2 >= 0, device=self.device))
        self._R1, self._P1 = gi1.shape
        self._R2, self._P2 = gi2.shape
        # skip the host gather when the trajectory already IS the layout
        self._layout_is_identity = (
            len(self._host_layout) == len(self.indices1) + len(self.indices2)
            and np.array_equal(self._host_layout,
                               np.arange(len(self._host_layout))))
        self._masks = {self.device: (self._mask1, self._mask2)}
        self._copy_streams: dict = {}
        self.time_device = False
        self.stats: dict = {}

    def _device_pass(self, pos, box, scale, *, mode: str, cap: int,
                     use_pbc: bool, triclinic: bool, quantized: bool):
        """The whole per-batch device computation: optional u16
        dequantization, reshape into residue groups, distance kernel
        (pruned or dense), compaction, and fusion of the (n, idx, dist)
        outputs into one transfer buffer. Eager torch ops on the current
        stream."""
        if quantized:
            # the u16 grid travels as int16 bytes: undo the sign
            pos = (pos.to(torch.int32) & 0xFFFF).to(torch.float32)
            pos = pos * scale[:, :1, :] + scale[:, 1:, :]
        F = pos.shape[0]
        A1 = self._R1 * self._P1
        p1 = pos[:, :A1].reshape(F, self._R1, self._P1, 3)
        p2 = pos[:, A1:].reshape(F, self._R2, self._P2, 3)
        mask1, mask2 = self._masks_on(pos.device)
        if mode == "pruned":
            n, cidx, cdist = min_dist_pruned(
                p1, p2, self.cfg.map_cutoff, box, cap_pairs=cap,
                use_pbc=use_pbc, mask1=mask1, mask2=mask2,
                triclinic=triclinic)
            return self._fuse(n, cidx, cdist)
        dmin = min_dist_per_residue_pair(
            p1, p2, box, use_pbc=use_pbc, mask1=mask1,
            mask2=mask2, triclinic=triclinic)
        if mode == "dense_raw":
            # small system: the packed idx+dist buffers would be LARGER
            # than the dense matrix; transfer dmin itself
            return dmin
        n, cidx, cdist = compact_contacts(dmin, self.cfg.map_cutoff, cap)
        return dmin, self._fuse(n, cidx, cdist)

    def _masks_on(self, device):
        """The selections' slot masks on ``device`` (copied there once)."""
        if device not in self._masks:
            self._masks[device] = tuple(
                None if m is None else m.to(device)
                for m in (self._mask1, self._mask2))
        return self._masks[device]

    @staticmethod
    def _fuse(n, cidx, cdist):
        """(n, idx, dist) as ONE int32 (F, 1 + 2 cap) buffer, the
        distances' bits carried as they are: one device-to-host copy a
        batch instead of three."""
        return torch.cat([n[:, None], cidx,
                          cdist.contiguous().view(torch.int32)], dim=1)

    @staticmethod
    def _unfuse(arr: np.ndarray):
        cap = (arr.shape[1] - 1) // 2
        return (arr[:, 0].astype(np.int64),
                arr[:, 1:1 + cap].astype(np.int64),
                arr[:, 1 + cap:].view(np.float32))

    def _fingerprint(self) -> str:
        """Identity of this scan for checkpoint validation: the package,
        the selections and every config field that changes the output
        rows."""
        h = hashlib.sha256(_ENGINE_TAG)
        for arr in (self.indices1, self.indices2,
                    self.group_idx1, self.group_idx2,
                    self.uniq_resids1, self.uniq_resids2):
            h.update(np.ascontiguousarray(arr).tobytes())
        h.update(repr((self.cfg.map_cutoff, self.cfg.use_pbc,
                       self.cfg.upload_dtype,
                       self.meta.top, self.meta.traj,
                       self.meta.ts)).encode())
        return h.hexdigest()

    def _prefilter_active(self) -> bool:
        """Bounding-sphere pruning on/off (ContactConfig.prefilter)."""
        mode = self.cfg.prefilter
        if mode == "auto":
            pairs = self._R1 * self._P1 * self._R2 * self._P2
            return pairs > int(self.cfg.prefilter_auto_pairs)
        return bool(mode)

    @staticmethod
    def _upload(arr: np.ndarray, dtype, device, take=None) -> torch.Tensor:
        """A host array (its atoms gathered by ``take``) as a tensor on
        ``device``: through a pinned staging buffer and a non-blocking copy
        on the current stream for the card."""
        arr = np.asarray(arr, dtype)
        if device.type == "cpu":
            arr = arr[:, take] if take is not None else arr
            return torch.from_numpy(np.array(arr, dtype, order="C"))
        shape = (arr.shape if take is None
                 else (arr.shape[0], len(take)) + arr.shape[2:])
        stage = torch.empty(shape, dtype=_TORCH_DTYPE[arr.dtype.type],
                            pin_memory=True)
        if take is None:
            np.copyto(stage.numpy(), arr)
        else:
            np.take(arr, take, axis=1, out=stage.numpy())
        return stage.to(device, non_blocking=True)

    def _prepare(self, batch: FrameBatch):
        """Host-side batch preparation: residue-padded layout, optional u16
        quantization, and the upload on the copy stream (of each frame
        shard's device). Runs on the prefetch thread so the upload of
        batch i + 1 overlaps the device compute of batch i."""
        t0 = time.perf_counter()
        positions, boxarr = batch.positions, batch.box
        quantized = self.cfg.upload_dtype == "u16"
        take = None if self._layout_is_identity else self._host_layout
        scale = None
        if quantized:
            positions = np.asarray(positions)
            if take is not None:
                positions = positions[:, take, :]
            take = None
            # shared shifted-domain quantizer (contacts/quantize.py); one
            # (F, 2, 3) buffer: row 0 the grid step, row 1 the offset; the
            # device dequant is pos * step + lo
            q, scale = quantize_u16(positions)
            positions = q.view(np.int16)
        n = len(self.devices)
        if n == 1:
            out = self._prepare_on(self.device, positions, boxarr, scale,
                                   take)
        else:
            # pad the frame axis to the shard count with the last frame;
            # shard s takes the s-th equal run of frames
            F = len(positions)
            pad = -F % n
            per = (F + pad) // n

            def padded(a):
                if a is None or not pad:
                    return a
                a = np.asarray(a)
                return np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])

            positions, boxarr, scale = map(padded, (positions, boxarr,
                                                    scale))
            shard = (lambda a, s: None if a is None  # noqa: E731
                     else a[s * per:(s + 1) * per])
            out = _FrameShards(
                [self._prepare_on(dev, shard(positions, s),
                                  shard(boxarr, s), shard(scale, s), take)
                 for s, dev in enumerate(self.devices)],
                [min(per, F - s * per) for s in range(n)])
        self.stats["prepare_s"] += time.perf_counter() - t0
        return out

    def _prepare_on(self, device, positions, boxarr, scale, take):
        """Upload one (shard of a) batch to ``device`` on its copy stream:
        the positions (int16 u16 grid with its ``scale``, or f32 with its
        atoms gathered by ``take``) and the box."""
        use_pbc = self.cfg.use_pbc and boxarr is not None
        triclinic = use_pbc and boxarr.ndim == 3
        quantized = scale is not None
        on_card = device.type == "cuda"
        if on_card and device not in self._copy_streams:
            self._copy_streams[device] = torch.cuda.Stream(device)
        with (torch.cuda.stream(self._copy_streams[device]) if on_card
              else contextlib.nullcontext()):
            if quantized:
                pos = self._upload(positions, np.int16, device)
                scale = self._upload(scale, np.float32, device)
            else:
                pos = self._upload(positions, np.float32, device, take)
            box = (self._upload(boxarr, np.float32, device) if use_pbc
                   else None)
            ready = None
            if on_card:
                ready = torch.cuda.Event()
                ready.record()
        return pos, box, scale, use_pbc, triclinic, quantized, ready

    def _exec_pass(self, prep, mode: str, cap: int):
        """One device pass of a prepared batch; on frame shards, one pass a
        shard, each on its device, its results cut to its real frames
        ('dense' gives (dmin list, fused list))."""
        self.stats["passes"][mode] += 1
        if not isinstance(prep, _FrameShards):
            return self._exec_on(prep, mode, cap)
        outs = [self._exec_on(p, mode, cap) for p in prep.preps]
        if mode == "dense":
            return tuple([o[i][:n] for o, n in zip(outs, prep.real)]
                         for i in (0, 1))
        return [o[:n] for o, n in zip(outs, prep.real)]

    def _exec_on(self, prep, mode: str, cap: int):
        pos, box, scale, use_pbc, triclinic, quantized, ready = prep
        events = None
        if ready is not None:
            stream = torch.cuda.current_stream(pos.device)
            stream.wait_event(ready)
            for t in (pos, box, scale):
                if t is not None:
                    t.record_stream(stream)
            if self.time_device:
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record(stream)
        with (torch.cuda.device(pos.device) if ready is not None
              else contextlib.nullcontext()):
            out = self._device_pass(pos, box, scale, mode=mode, cap=cap,
                                    use_pbc=use_pbc, triclinic=triclinic,
                                    quantized=quantized)
        if events is not None:
            events[1].record(stream)
            self._timed.append(events)
        return out

    def run(self, trajectory: Iterable[FrameBatch], progress_cb=None,
            spill_dir: Optional[str] = None,
            checkpoint_dir: Optional[str] = None,
            checkpoint_every: int = 200_000) -> ContactRecords:
        """Stream frame batches through the distance kernel and collect all
        residue pairs within the map cutoff.

        ``checkpoint_dir`` enables durable mid-scan checkpoints every
        ``checkpoint_every`` frames: a preempted scan rerun with the same
        arguments resumes from the last checkpoint and produces the
        identical ContactRecords (the trajectory iterable must yield the
        same frames in the same monotonic order). The directory survives
        the run; remove it with :meth:`remove_checkpoint` once the
        records are durably saved.
        """
        cols = _ColumnStore(self.cfg.host_row_budget, spill_dir)
        last_time = None
        frame_diffs: list = []   # every consecutive frame-time gap
        pending = None  # (kind, device result, real frame count, batch, prep)
        prefilter = self._prefilter_active()
        self.stats = {"frames": 0, "batches": 0, "prepare_s": 0.0,
                      "collect_s": 0.0, "device_s": None, "retries_exact": 0,
                      "fallbacks_dense": 0, "dense_overflows": 0,
                      "passes": {"pruned": 0, "dense": 0, "dense_raw": 0}}
        self._timed: list = []

        ckpt = None
        start_frame = 0
        if checkpoint_dir is not None:
            ckpt = _Checkpointer(checkpoint_dir, self._fingerprint(),
                                 checkpoint_every)
            loaded = ckpt.load()
            if loaded is not None:
                lcols, ldiffs, last_time, start_frame = loaded
                if lcols["frames"].size:
                    cols.append(lcols["frames"], lcols["s1"], lcols["s2"],
                                lcols["dist"], lcols["times"])
                if ldiffs.size:
                    frame_diffs.append(ldiffs)

        n_pairs_total = self._R1 * self._R2
        exec_pass, unfuse = self._exec_pass, self._unfuse

        def dense_pack(prep):
            # compact on the card: only sub-cutoff entries cross to the
            # host. dmin stays on the card as the exact fallback for
            # overflowing frames. Small systems (n_pairs <= cap) skip
            # compaction: the packed idx+dist buffers would be LARGER
            # than the dense matrix.
            cap = int(self.cfg.transfer_cap)
            if n_pairs_total <= cap:
                dmin = exec_pass(prep, "dense_raw", 0)
                return "dense", (dmin, None, _HostCopy(dmin))
            dmin, fused = exec_pass(prep, "dense", cap)
            return "dense", (dmin, _HostCopy(fused), None)

        # adaptive prefilter cap: the exact atom sweep and the host
        # transfer both scale with cap_pairs, so batches run at the
        # smallest power-of-two cap that held every frame so far (1.25x
        # margin). Undershoots are redone at the exact fit (n_pl is the
        # true per-frame count, independent of the cap), so adaptation
        # never changes the rows, only the work.
        cap_max = int(self.cfg.prefilter_cap)
        cap0 = min(max(int(self.cfg.prefilter_cap_min), 16), cap_max)
        cap_state = {"cap": cap0, "peak": 0}

        def _pow2ceil(x: int) -> int:
            return 1 << (max(int(x), 1) - 1).bit_length()

        def dispatch(prep):
            if prefilter:
                return "pruned", _HostCopy(
                    exec_pass(prep, "pruned", cap_state["cap"]))
            return dense_pack(prep)

        def decode_compact(cidx, cd, batch, R2):
            fk, kk = np.nonzero(cd <= self.cfg.map_cutoff)
            flat = cidx[fk, kk]
            # re-sort within frames by pair index: identical row order
            # (and bit-identical distances) to the dense path
            order = np.lexsort((flat, fk))
            fk, flat = fk[order], flat[order]
            dist = cd[fk, kk[order]].astype(np.float32)
            i, j = flat // R2, flat % R2
            s1 = self.uniq_resids1[i].astype(np.int32)
            s2 = self.uniq_resids2[j].astype(np.int32)
            f = np.asarray(batch.frame_ids)[fk].astype(np.int64)
            t = np.asarray(batch.times, np.float64)[fk]
            return f, s1, s2, dist, t

        def collect(kind, pack, F_real, batch, prep):
            nonlocal last_time
            t0 = time.perf_counter()
            R2 = self._R2
            if kind == "pruned":
                n_pl, cidx, cdist = unfuse(pack.numpy())
                peak = int(n_pl.max()) if len(n_pl) else 0
                cap_state["peak"] = max(cap_state["peak"], peak)
                if peak > cidx.shape[1]:
                    if peak > cap_max:
                        # past the cap ceiling: redo the batch densely
                        # (exactness guard; the prefilter only ever drops
                        # pairs that are provably beyond the cutoff)
                        self.stats["fallbacks_dense"] += 1
                        kind, pack = dense_pack(prep)
                    else:
                        need = min(_pow2ceil(peak), cap_max)
                        # the adaptive cap undershot this batch: redo at
                        # the exact fit (n_pl is the true count, so one
                        # retry always holds every frame)
                        self.stats["retries_exact"] += 1
                        ret = _HostCopy(exec_pass(prep, "pruned", need))
                        n_pl, cidx, cdist = unfuse(ret.numpy())
                        rows = decode_compact(cidx, cdist, batch, R2)
                else:
                    rows = decode_compact(cidx, cdist, batch, R2)
                cap_state["cap"] = min(
                    max(_pow2ceil((5 * cap_state["peak"]) // 4), cap0),
                    cap_max)
            if kind == "dense":
                dmin_dev, fused, dmin_host = pack
                if fused is not None:
                    nhit, cidx, cdist = unfuse(fused.numpy())
                    if (nhit > cidx.shape[1]).any():
                        # pathologically dense frame (cap overflow): exact
                        # dense transfer
                        self.stats["dense_overflows"] += 1
                        dmin_host = _HostCopy(dmin_dev)
                if dmin_host is not None:
                    rows = contacts_from_batch(
                        dmin_host.numpy(), np.asarray(batch.frame_ids),
                        np.asarray(batch.times), self.uniq_resids1,
                        self.uniq_resids2, self.cfg.map_cutoff)
                else:
                    rows = decode_compact(cidx, cdist, batch, R2)
            bt = np.asarray(batch.times, np.float64)[:F_real]
            bf = np.asarray(batch.frame_ids)[:F_real]
            if start_frame and len(bf) and bf[0] < start_frame:
                # resume landed mid-batch: drop rows/times of frames the
                # checkpoint already covers
                keep = rows[0] >= start_frame
                rows = tuple(c[keep] for c in rows)
                bt = bt[bf >= start_frame]
            cols.append(*rows)
            new_diffs = []
            if len(bt) > 0:
                if last_time is not None:
                    new_diffs.append(bt[0] - last_time)
                if len(bt) > 1:
                    new_diffs.append(np.diff(bt))
                last_time = float(bt[-1])
            frame_diffs.extend(new_diffs)
            self.stats["frames"] += len(bt)
            self.stats["batches"] += 1
            if ckpt is not None and len(bf):
                ckpt.add(rows, new_diffs, int(bf[-1]) + 1, last_time)
            self.stats["collect_s"] += time.perf_counter() - t0
            if progress_cb is not None:
                progress_cb(int(batch.frame_ids[-1]) + 1)

        # two-stage pipeline: a prefetch thread prepares + uploads batch
        # i+1 (host layout, quantization, the pinned copy) while the card
        # computes batch i and the main thread decodes batch i-1's
        # results; kernel launches are asynchronous, the wait happens in
        # collect
        from concurrent.futures import ThreadPoolExecutor

        def batches():
            for batch in trajectory:
                if start_frame and int(batch.frame_ids[-1]) < start_frame:
                    # checkpoint already covers this whole batch
                    if progress_cb is not None:
                        progress_cb(int(batch.frame_ids[-1]) + 1)
                    continue
                yield batch

        with ThreadPoolExecutor(max_workers=1) as ex:
            it = batches()
            nxt = next(it, None)
            fut = ex.submit(self._prepare, nxt) if nxt is not None else None
            while nxt is not None:
                batch, prep = nxt, fut.result()
                nxt = next(it, None)
                if nxt is not None:
                    fut = ex.submit(self._prepare, nxt)
                kind, pack = dispatch(prep)
                if pending is not None:
                    collect(*pending)
                pending = (kind, pack, len(batch.frame_ids), batch, prep)
            if pending is not None:
                collect(*pending)
        self.stats["cap"] = cap_state["cap"]
        if self._timed:
            for dev in set(self.devices):
                torch.cuda.synchronize(dev)
            self.stats["device_s"] = sum(
                a.elapsed_time(b) for a, b in self._timed) / 1e3
            self._timed = []

        meta = dataclasses.replace(self.meta, cutoff=self.cfg.map_cutoff)
        if meta.ts is None and frame_diffs:
            # infer ts from the *full* frame-time vector: a first-two-frames
            # guess silently corrupts event merging on 1-frame first batches
            # or irregular strides (events.py keys durations off ts).
            # Trajectory times are stored as float32, so gaps between late
            # frames carry ~|t| * 2^-23 of quantization jitter: take the
            # median gap (jitter-unbiased, unlike the minimum) and size the
            # regularity tolerance to the quantum.
            d = np.hstack(frame_diffs)
            ts = float(np.median(d))
            quantum = 4.0 * abs(last_time) * 2.0 ** -23
            tol = 1e-4 * ts + quantum
            if ts <= 0 or float(np.abs(d - ts).max()) > tol:
                raise ValueError(
                    f"irregular frame-time stride (gaps span {d.min():g} to "
                    f"{d.max():g} ns); event durations would be wrong. Pass "
                    "an explicit ContactMeta(ts=...) for this trajectory.")
            meta.ts = ts
        cat = cols.finalize()
        # the checkpoint directory is intentionally NOT removed here: the
        # records only exist in memory until the caller persists them, and
        # deleting the checkpoint first would lose the scan to a failed
        # save. Call remove_checkpoint(checkpoint_dir) once the artifact
        # is durably written (a rerun before that resumes idempotently).
        return ContactRecords(cat["frames"], cat["s1"], cat["s2"],
                              cat["dist"], cat["times"], meta)

    @staticmethod
    def remove_checkpoint(checkpoint_dir: str) -> None:
        """Discard a scan checkpoint; call after the records artifact is
        durably saved."""
        shutil.rmtree(checkpoint_dir, ignore_errors=True)


class ProcessContacts:
    """Impose the analysis cutoff and merge contacts into residence events
    (reference contacts.py:135-231)."""

    def __init__(self, cutoff: float = 7.0):
        self.cutoff = cutoff

    def run(self, records: ContactRecords) -> ContactEvents:
        return merge_events(records, self.cutoff)
