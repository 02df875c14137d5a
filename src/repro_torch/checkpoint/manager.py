"""Checkpointing with HPDR compression (counterpart of
``repro.checkpoint.manager``; the same layout and manifest, so a checkpoint
written by either package restores in the other).

  * per-tensor method selection by tensor class — float weights and moments
    through ZFP fixed-rate or MGARD error-bounded; integer state and
    anything that must restore bit-exact through lossless Huffman-bytes;
  * float leaves of ``stream_threshold`` bytes or more through the
    auto-tuned chunk-pipelined ``CompressorStream``;
  * lossless leaves larger than ``LOSSLESS_CHUNK_BYTES`` (128 MiB) through
    the same stream in fixed chunks of that size: one Huffman stream holds
    at most 2^31 - 1 bits (the format's int32 bit offsets, ~256 MiB of
    codes), so a larger exact leaf — qwen2.5-3b's 1.24 GB embedding and
    its moments — cannot be one container.  The reference has the same
    limit and no such route; its restore reads these streamed leaves;
  * **engine-scheduled**: per-leaf compression fans out over the execution
    engine's devices (submit/result futures), and ``save_async`` runs the
    whole save on the engine's ``io`` lane against a snapshot;
  * **aggregated I/O**: every leaf's container coalesces into ONE aligned
    segment file per step (``leaves.hpdr``) written through
    :class:`repro_torch.runtime.io.AggregatedWriter`, with a segment
    directory so restore ``pread``s exactly the leaves it needs;
  * **multi-host sharded I/O**: under a multi-controller
    :class:`~repro_torch.launch.mesh.HostTopology` every host writes the
    leaves it owns to its own shard (``leaves-<host>.hpdr``), the hosts
    meet at a shared-filesystem barrier, and host 0 stitches the per-host
    directories into a **global manifest**; a same-topology restore
    ``pread``s only its local shard (``restore(leaves="local")``).

Leaves stay where they lie: a tensor on the card is compressed there and
only its compressed bytes cross to the host; a host array or tensor goes
to the card through the engine (one-shot leaves) or the stream's
page-locked staging (streamed leaves).  Restored leaves are tensors on the
engine's device; ``restore(target=..., shardings=...)`` re-places them
(``shardings``: a tree of per-leaf ``torch.device``\\ s, or of
``runtime.sharding.Placed`` placements over a mesh, the reference's mesh
shardings: each rank keeps its block of the decoded leaf).  A placed leaf
(a DTensor) is saved whole: gathered to the full tensor on every rank
first, so the containers are those of the unplaced leaf, and a checkpoint
written placed, unplaced or by the reference restores either way.

Layout:  <dir>/step_<N>/manifest.json + <dir>/step_<N>/leaves.hpdr
         (multi-host: <dir>/step_<N>/leaves-<host>.hpdr per host)
         (pre-aggregation checkpoints: <dir>/step_<N>/<leaf-path>.hpdr)
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..core import adapters, api
from ..core import engine as engine_mod
from ..core.container import Compressed, _jsonable
from ..core.pipeline import host_tensor
from ..launch.mesh import HostTopology, barrier_payloads, fs_barrier
from ..runtime.executor import IO, Submission
from ..runtime.sharding import Placed, is_placed
from ..runtime.io import (
    AggregatedReader,
    AggregatedWriter,
    ShardSetReader,
    shard_file_name,
    stitch_shard_directories,
)

_SEP = "::"
_AGGREGATE_FILE = "leaves.hpdr"
_COMMIT_POLL_S = 0.005
# numpy's kind "f": bfloat16 (kind "V" there) restores bit-exact, as in the reference
_FLOATS = (torch.float16, torch.float32, torch.float64)


@dataclass(frozen=True)
class CheckpointPolicy:
    # zfp | mgard | mgard-progressive | huffman-bytes (lossless);
    # mgard-progressive writes one segment per precision tier so restore
    # can pread a prefix (restore(max_error=...))
    float_method: str = "zfp"
    zfp_rate: int = 28               # bits/value — ~1e-6 rel err, 1.14× smaller
    mgard_eb: float = 1e-6
    progressive_tiers: int = 3       # precision components per leaf
    progressive_ratio: float = 8.0   # bound ratio between adjacent tiers
    lossless_small: int = 16384      # tensors below this many elems: lossless
    exact: bool = False              # force lossless everywhere
    # float leaves at/above this many bytes go through the auto-tuned
    # chunked CompressorStream (chunk_size="auto", window="auto") and the
    # leaf's segment becomes a framed HPDS stream.  None disables.
    stream_threshold: int | None = 8 << 20
    # fsync shard/aggregate files (and their directory entries) on close
    fsync: bool = False
    # how long a host waits at the save barrier / for the coordinator's
    # global-manifest commit before declaring the save torn
    barrier_timeout_s: float = 120.0


def _leaf(x: Any) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else host_tensor(np.asarray(x))


def _flatten(tree: Any) -> dict[str, torch.Tensor]:
    """``{key: tensor}`` in the reference's order, with its ``::`` keys."""
    return {key: _leaf(leaf) for key, leaf in api.flatten_with_keys(tree, _SEP)}


def _nbytes(arr: torch.Tensor) -> int:
    return arr.numel() * arr.element_size()


def _method_for(arr: torch.Tensor, policy: CheckpointPolicy) -> tuple[str, dict]:
    if policy.exact or arr.dtype not in _FLOATS or arr.numel() < policy.lossless_small:
        return "huffman-bytes", {}
    if policy.float_method == "zfp":
        return "zfp", {"rate": policy.zfp_rate}
    if policy.float_method == "mgard":
        return "mgard", {"error_bound": policy.mgard_eb, "relative": True}
    if policy.float_method == "mgard-progressive":
        return "mgard-progressive", {
            "error_bound": policy.mgard_eb, "relative": True,
            "tiers": policy.progressive_tiers,
            "tier_ratio": policy.progressive_ratio,
        }
    return "huffman-bytes", {}


def _compress_leaf(
    arr: torch.Tensor, policy: CheckpointPolicy, backend: str
) -> bytes | tuple[str, dict, list[bytes]]:
    """One leaf's serialised form: container bytes, or — for progressive
    leaves — ``("progressive", manifest, component_blobs)`` so the writer
    can store each precision tier as its own addressable segment."""
    method, kw = _method_for(arr, policy)
    c = api.compress_leaf(arr, method, backend=backend, **kw)
    if c.method == "mgard-progressive":
        from ..core import progressive

        comps = [
            np.ascontiguousarray(c.arrays[progressive.component_name(t)]).tobytes()
            for t in range(len(c.meta["tier_bounds"]))
        ]
        return ("progressive", _jsonable(c.meta), comps)
    return c.to_bytes()


def _restore_progressive(meta: dict, blobs: list[bytes], backend: str) -> torch.Tensor:
    """Reconstruct a progressive leaf from a component-blob prefix."""
    from ..core import progressive

    stream = progressive.ProgressiveStream(
        manifest={
            k: meta[k]
            for k in ("shape", "padded", "L", "dict_size",
                      "tier_bounds", "component_nbytes")
        },
        components=list(blobs),
    )
    out = progressive.retrieve(stream, backend=backend)
    stub = Compressed(method="mgard-progressive", meta=meta, arrays={})
    return api.restore_leaf(out, stub)


# A Huffman code of the 256 byte values spends at most 8 bits a byte on
# average (the fixed 8-bit code is a prefix code), so a chunk of this many
# bytes fills at most half of the 2^31 - 1 bits one stream can hold.
LOSSLESS_CHUNK_BYTES = 128 << 20


def _lossless_chunks(arr: torch.Tensor, policy: CheckpointPolicy) -> bool:
    """A ``huffman-bytes`` leaf too large for one container."""
    return (_method_for(arr, policy)[0] == "huffman-bytes"
            and _nbytes(arr) > LOSSLESS_CHUNK_BYTES)


def _should_stream(arr: torch.Tensor, policy: CheckpointPolicy) -> bool:
    if _lossless_chunks(arr, policy):
        return True
    if policy.stream_threshold is None or policy.exact:
        return False
    if policy.float_method == "mgard-progressive":
        # progressive leaves write per-tier segments, not a framed stream —
        # prefix addressability is the whole point
        return False
    return arr.dtype in _FLOATS and _nbytes(arr) >= policy.stream_threshold


def _stream_leaf(arr: torch.Tensor, policy: CheckpointPolicy, backend: str) -> tuple[bytes, dict]:
    """Compress one large leaf through the auto-tuned chunked stream.

    Runs *inline on the caller's thread* with a standalone (engine-free)
    CompressorStream: ``save_async`` executes ``save`` on the engine's
    single io worker, and a stream whose staging loop occupied an engine
    lane while waiting on that same lane's serialize futures would
    deadlock.  The standalone stream brings its own transient executor.
    """
    method, kw = _method_for(arr, policy)
    if _lossless_chunks(arr, policy):
        chunk, window = LOSSLESS_CHUNK_BYTES // arr.element_size(), 2
    else:
        chunk, window = "auto", "auto"
    stream = api.CompressorStream(
        method, chunk_size=chunk, window=window, frame=True, backend=backend, **kw
    )
    res = stream.compress(arr)
    info = {"window": res.window}
    if res.tuned is not None:
        info["tuned"] = res.tuned
    return stream.to_bytes(res), info


def _gathered(tree: Any) -> Any:
    """``tree`` with every placed leaf (DTensor) gathered to its full tensor
    (a collective: every rank of its mesh calls this, in the same order)."""
    flat = dict(api.flatten_with_keys(tree, _SEP))
    if not any(is_placed(x) for x in flat.values()):
        return tree
    return api.unflatten_like(
        tree, lambda k: flat[k].full_tensor() if is_placed(flat[k]) else flat[k], _SEP)


def _snapshot(tree: Any) -> Any:
    """A copy of ``tree`` the caller may go on mutating: tensors cloned where
    they lie (the card's copies complete before this returns), arrays
    copied."""
    def copy(key: str) -> Any:
        x = flat[key]
        return x.detach().clone() if isinstance(x, torch.Tensor) else np.array(x)

    flat = dict(api.flatten_with_keys(tree, _SEP))
    out = api.unflatten_like(tree, copy, _SEP)
    for dev in {x.device for x in flat.values() if isinstance(x, torch.Tensor) and x.is_cuda}:
        torch.cuda.current_stream(dev).synchronize()
    return out


class CheckpointManager:
    """Save and restore HPDR-compressed checkpoints.

    Runs on ``engine`` (default: the process-wide engine on the card; with
    ``backend="torch"`` and no engine, a CPU engine of the manager's own,
    shut down by :meth:`close`).  Without a card and without
    ``backend="torch"`` (or a CPU engine), saving raises.
    """

    def __init__(
        self,
        directory: str | Path,
        policy: CheckpointPolicy | None = None,
        engine: engine_mod.ExecutionEngine | None = None,
        topology: HostTopology | None = None,
        *,
        backend: str | None = None,
    ):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.policy = policy or CheckpointPolicy()
        self._engine = engine
        self._own_engine = False
        self._backend = backend
        self._topology = topology
        self._pending: Submission | None = None
        self.last_report: dict | None = None
        #: pread-locality stats of the most recent ``restore``
        self.last_restore_io: dict | None = None

    @property
    def engine(self) -> engine_mod.ExecutionEngine:
        if self._engine is None:
            if adapters.resolve_backend(self._backend) == adapters.CUDA:
                self._engine = engine_mod.default_engine()
            else:
                self._engine = engine_mod.ExecutionEngine(backend=self._backend)
                self._own_engine = True
        return self._engine

    @property
    def backend(self) -> str:
        return self.engine.backend

    @property
    def topology(self) -> HostTopology:
        """Explicit topology, else the engine's."""
        return self._topology if self._topology is not None else self.engine.topology

    def close(self) -> None:
        """Wait for a pending async save; shut down an engine of the
        manager's own."""
        try:
            self.wait()
        finally:
            if self._own_engine:
                self._engine.close()
                self._engine, self._own_engine = None, False

    # ----------------------------------------------------------------- save

    def save(self, step: int, tree: Any, extra: dict | None = None) -> dict:
        tree = _gathered(tree)
        topo = self.topology
        if topo.multi_host:
            return self._save_multihost(step, tree, extra, topo)
        return self._save_single(step, tree, extra)

    def _submit_leaf_compressions(self, flat: dict) -> list[tuple]:
        """Fan per-leaf compression out across the engine (compute lane).

        Large float leaves bypass the one-shot path and go through the
        auto-tuned chunked stream *inline on the save thread* (see
        ``_stream_leaf`` for why they must not occupy an engine lane);
        everything else fans out across the engine.
        """
        backend = self.backend
        return [
            (
                key,
                arr,
                None
                if _should_stream(arr, self.policy)
                else self.engine.submit(_compress_leaf, arr, self.policy, backend),
            )
            for key, arr in flat.items()
        ]

    def _write_leaves(
        self, writer: AggregatedWriter, subs: list[tuple]
    ) -> tuple[dict, int, int]:
        """Drain compression futures into ``writer``; returns
        ``(leaf_entries, raw_total, comp_total)``."""
        entries: dict[str, dict] = {}
        raw_total, comp_total = 0, 0
        used: set[str] = set()
        for key, arr, sub in subs:
            stream_info = None
            if sub is None:
                blob, stream_info = _stream_leaf(arr, self.policy, self.backend)
            else:
                blob = sub.result()
            # sanitize separators and dedupe: distinct keys must never
            # share a segment
            base = key.replace(_SEP, "__").replace("/", "_") or "_root"
            name, i = base, 2
            while name in used:
                name = f"{base}~{i}"
                i += 1
            used.add(name)
            raw = _nbytes(arr)
            if isinstance(blob, tuple) and blob[0] == "progressive":
                # one addressable segment per precision tier
                _, pmeta, comps = blob
                seg_names, total = [], 0
                for t, comp in enumerate(comps):
                    seg = f"{name}~p{t:02d}"
                    writer.add(seg, comp)
                    seg_names.append(seg)
                    total += len(comp)
                entries[key] = {
                    "segments": seg_names, "bytes": total,
                    "raw": raw, "progressive": pmeta,
                }
                raw_total += raw
                comp_total += total
                continue
            writer.add(name, blob)
            entry = {"segment": name, "bytes": len(blob), "raw": raw}
            if stream_info is not None:
                entry["stream"] = True
                entry.update(stream_info)
            entries[key] = entry
            raw_total += raw
            comp_total += len(blob)
        return entries, raw_total, comp_total

    def _save_single(self, step: int, tree: Any, extra: dict | None) -> dict:
        t0 = time.perf_counter()
        flat = _flatten(tree)
        step_dir = self.dir / f"step_{step:08d}"
        step_dir.mkdir(parents=True, exist_ok=True)
        manifest = {"step": step, "extra": extra or {},
                    "aggregate": _AGGREGATE_FILE, "leaves": {}}
        subs = self._submit_leaf_compressions(flat)
        with AggregatedWriter(
            step_dir / _AGGREGATE_FILE, meta={"step": step},
            fsync=self.policy.fsync, atomic=True,
        ) as writer:
            entries, raw_total, comp_total = self._write_leaves(writer, subs)
        manifest["leaves"] = entries
        io_stats = dict(writer.stats)  # after close(): counts the final flush
        manifest["raw_bytes"] = raw_total
        manifest["compressed_bytes"] = comp_total
        manifest["ratio"] = raw_total / max(comp_total, 1)
        manifest["save_s"] = time.perf_counter() - t0
        manifest["io"] = io_stats
        (step_dir / "manifest.json").write_text(json.dumps(manifest, indent=1))
        # commit marker: restore only sees completed checkpoints
        (step_dir / "COMMITTED").write_text("ok")
        self.last_report = manifest
        return manifest

    def _save_multihost(
        self, step: int, tree: Any, extra: dict | None, topo: HostTopology
    ) -> dict:
        """Per-host shard writers + coordinator-stitched global manifest.

        Every host compresses exactly the leaves it owns and writes them
        (atomically) into ``leaves-<host>.hpdr``; the hosts rendezvous on a
        shared-filesystem barrier whose marker payload carries each
        writer's partial manifest, and host 0 stitches the per-host
        directories into the global ``manifest.json`` before writing
        ``COMMITTED``.  Non-coordinators block on the commit marker, so
        every host returns the same manifest.
        """
        t0 = time.perf_counter()
        flat = _flatten(tree)
        step_dir = self.dir / f"step_{step:08d}"
        step_dir.mkdir(parents=True, exist_ok=True)
        owned = {k: a for k, a in flat.items() if topo.owns(k)}
        subs = self._submit_leaf_compressions(owned)
        shard = shard_file_name(topo.host_id)
        with AggregatedWriter(
            step_dir / shard,
            meta={"step": step, "host": topo.host_id, "hosts": topo.n_hosts},
            fsync=self.policy.fsync, atomic=True,
        ) as writer:
            entries, raw_total, comp_total = self._write_leaves(writer, subs)
        payload = json.dumps({
            "host": topo.host_id, "file": shard, "leaves": entries,
            "raw_bytes": raw_total, "compressed_bytes": comp_total,
            "io": dict(writer.stats), "save_s": time.perf_counter() - t0,
        })
        fs_barrier(step_dir, f"save-{step}", topo,
                   timeout=self.policy.barrier_timeout_s, payload=payload)
        if topo.host_id == 0:
            manifest = self._stitch_global_manifest(step, step_dir, extra, topo, t0)
        else:
            self._wait_for_commit(step_dir)
            manifest = json.loads((step_dir / "manifest.json").read_text())
        self.last_report = manifest
        return manifest

    def _stitch_global_manifest(
        self, step: int, step_dir: Path, extra: dict | None,
        topo: HostTopology, t0: float,
    ) -> dict:
        payloads = {
            h: json.loads(raw)
            for h, raw in barrier_payloads(step_dir, f"save-{step}", topo).items()
        }
        shard_files = {str(h): p["file"] for h, p in payloads.items()}
        # validate every shard's trailer before committing anything: a torn
        # host write must fail the global commit, not surface at restore
        stitched = stitch_shard_directories(step_dir, shard_files)
        manifest: dict = {
            "step": step, "extra": extra or {},
            "shards": shard_files,
            "topology": {"hosts": topo.n_hosts},
            "leaves": {}, "io": {},
        }
        raw_total = comp_total = 0
        for h in sorted(payloads):
            p = payloads[h]
            for key, entry in p["leaves"].items():
                manifest["leaves"][key] = {**entry, "shard": str(h)}
            raw_total += int(p["raw_bytes"])
            comp_total += int(p["compressed_bytes"])
            manifest["io"][str(h)] = p["io"]
        manifest["raw_bytes"] = raw_total
        manifest["compressed_bytes"] = comp_total
        manifest["ratio"] = raw_total / max(comp_total, 1)
        manifest["save_s"] = time.perf_counter() - t0
        manifest["stitched_segments"] = stitched["segments"]
        (step_dir / "manifest.json").write_text(json.dumps(manifest, indent=1))
        (step_dir / "COMMITTED").write_text("ok")
        return manifest

    def _wait_for_commit(self, step_dir: Path) -> None:
        deadline = time.monotonic() + self.policy.barrier_timeout_s
        marker = step_dir / "COMMITTED"
        while not marker.exists():
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{step_dir}: coordinator never committed the global "
                    f"manifest within {self.policy.barrier_timeout_s}s"
                )
            time.sleep(_COMMIT_POLL_S)

    def save_async(self, step: int, tree: Any, extra: dict | None = None) -> Submission:
        """Snapshot, then compress+write on the engine's io lane.

        The returned :class:`Submission` resolves to the manifest; training
        continues right after the snapshot.  A previous in-flight save is
        *chained*, not waited on.  If the previous save failed, its
        exception propagates from this submission's ``result()`` (the
        chained save is skipped).
        """
        snapshot = _snapshot(_gathered(tree))  # the only sync point
        prev, self._pending = self._pending, None
        if prev is None:
            self._pending = self.engine.submit(self.save, step, snapshot, extra, lane=IO)
        else:
            self._pending = self.engine.executor.submit_after(
                prev, lambda _prev_manifest: self.save(step, snapshot, extra),
                lane=IO,
            )
        return self._pending

    def wait(self) -> dict | None:
        if self._pending is not None:
            pending, self._pending = self._pending, None
            return pending.result()
        return None

    # -------------------------------------------------------------- restore

    def latest_step(self) -> int | None:
        steps = [
            int(p.name.split("_")[1])
            for p in self.dir.glob("step_*")
            if (p / "COMMITTED").exists()
        ]
        return max(steps) if steps else None

    def restore(
        self,
        step: int | None = None,
        target: Any | None = None,
        shardings: Any | None = None,
        leaves: Any | None = None,
        max_error: float | None = None,
    ) -> tuple[Any, dict]:
        """Load a checkpoint as tensors (decoded on the engine's device).

        ``max_error`` (absolute L∞ bound) makes the restore *progressive*:
        leaves checkpointed with ``float_method="mgard-progressive"`` read
        only the component prefix whose tier bound satisfies it.  Leaves
        stored any other way are at final precision already.

        ``target`` supplies the pytree structure (and each leaf's dtype, and
        its device where the leaf is a tensor); ``shardings`` (same
        structure, ``torch.device`` or ``runtime.sharding.Placed`` leaves)
        re-places every leaf: a placement keeps this rank's block of the
        decoded leaf (no communication: every rank decodes the whole
        leaf).
        ``leaves`` (flat mode only) selects a subset of leaf keys: only
        those leaves' byte ranges are ``pread``.  ``leaves="local"`` selects
        the leaves this host owns under its current topology.
        """
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no committed checkpoints in {self.dir}")
        step_dir = self.dir / f"step_{step:08d}"
        manifest = json.loads((step_dir / "manifest.json").read_text())
        if leaves is not None and target is not None:
            raise ValueError("leaves= selects a subset; incompatible with target=")
        topo = self.topology
        backend = self.backend
        if isinstance(leaves, str) and leaves == "local":
            wanted: set | None = {k for k in manifest["leaves"] if topo.owns(k)}
        else:
            wanted = None if leaves is None else set(leaves)
        shard_files = manifest.get("shards")
        reader: AggregatedReader | None = None
        shard_set: ShardSetReader | None = None
        if shard_files:
            # locality only exists when the writing topology matches ours
            same_topo = manifest.get("topology", {}).get("hosts") == topo.n_hosts
            shard_set = ShardSetReader(
                step_dir, shard_files,
                local=str(topo.host_id) if same_topo else None,
            )
        elif manifest.get("aggregate"):
            reader = AggregatedReader(step_dir / manifest["aggregate"])
        try:
            flat = {}
            for key, info in manifest["leaves"].items():
                if wanted is not None and key not in wanted:
                    continue
                if "segments" in info:  # progressive: per-tier segments
                    pmeta = info["progressive"]
                    bounds = [float(b) for b in pmeta["tier_bounds"]]
                    k = len(bounds)
                    if max_error is not None:
                        k = next(
                            (i + 1 for i, b in enumerate(bounds) if b <= float(max_error)),
                            k,
                        )
                    blobs = [
                        shard_set.read(info["shard"], seg)
                        if shard_set is not None
                        else reader.read(seg)
                        for seg in info["segments"][:k]
                    ]
                    flat[key] = _restore_progressive(pmeta, blobs, backend)
                    continue
                if shard_set is not None:
                    raw = shard_set.read(info["shard"], info["segment"])
                elif "segment" in info:
                    raw = reader.read(info["segment"])
                else:  # pre-aggregation layout: one file per leaf
                    raw = (step_dir / info["file"]).read_bytes()
                if info.get("stream"):
                    flat[key] = api.CompressorStream.decompress(
                        api.CompressorStream.from_bytes(raw), backend)
                else:
                    flat[key] = api.decompress_leaf(Compressed.from_bytes(raw), backend)
        finally:
            if shard_set is not None:
                self.last_restore_io = dict(shard_set.stats)
                shard_set.close()
            elif reader is not None:
                self.last_restore_io = {
                    "local_preads": reader.preads, "cross_preads": 0,
                    "local_bytes": reader.pread_bytes, "cross_bytes": 0,
                    "shards_opened": [], "preads_by_shard": {},
                }
                reader.close()
            else:
                self.last_restore_io = {
                    "local_preads": 0, "cross_preads": 0,
                    "local_bytes": 0, "cross_bytes": 0,
                    "shards_opened": [], "preads_by_shard": {},
                }
        if target is None:
            return flat, manifest
        places = dict(api.flatten_with_keys(shardings, _SEP)) if shardings is not None else {}

        def leaf_for(key: str) -> torch.Tensor:
            like = dict_target[key]
            out = flat[key]
            if hasattr(like, "dtype"):
                out = out.to(_leaf(np.empty(0, like.dtype)).dtype
                             if isinstance(like, np.ndarray | np.generic) else like.dtype)
            where = places.get(key)
            if isinstance(where, Placed):
                out = where.distribute(out)
            elif where is not None:
                out = out.to(where)
            elif isinstance(like, torch.Tensor):
                out = out.to(like.device)
            return out

        dict_target = dict(api.flatten_with_keys(target, _SEP))
        return api.unflatten_like(target, leaf_for, _SEP), manifest
