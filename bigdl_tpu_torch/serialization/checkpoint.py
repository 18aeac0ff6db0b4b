"""Checkpoint save/load for parameter and optimizer trees.

Ports the single-process half of bigdl_tpu/serialization/checkpoint.py
(reference: `Module.saveModule` and `OptimMethod.save` at trigger time,
`Optimizer` resuming from the latest pair). The on-disk format is the
JAX package's, so a checkpoint written by either package loads in the
other:

    <dir>/<name>.npz        — leaves keyed by escaped tree path
    <dir>/<name>.json       — manifest: tree structure + metadata +
                              per-array crc32 checksums (format 2)

with the save units `model` ({"params": ..., "state": ...}), `optim`
(the optim method's slots as trees shaped like the params: the
optimizer rebuilds its flat slot lists into that shape, see
optim/optimizer.py) and, for a checkpoint taken mid-way through a
gradient-accumulation cycle, `accum` ({"g_acc": tree, "micro_n": n}).
Trees are nested dicts, lists, tuples and Tables of tensors or numpy
arrays; they come back as CPU tensors (or numpy arrays with
`as_torch=False`) for the caller to place.

Integrity: every array's crc32 is recorded at save time and checked
at load time; a torn or truncated npz, a garbled array or a missing
manifest raises CheckpointCorruptError. `Checkpoint.load()` catches
that per directory and falls back to the newest checkpoint that
verifies. A save builds up in `<dir>.inprogress` and is published by
atomic renames, so a crash at any point leaves either the previous
complete checkpoint or a staging dir that `latest()` never matches.

Async saves (`Checkpoint(path, async_save=True)`): `save` snapshots
every tree to host numpy on the caller's thread, then hands the
pure-I/O write to one background thread; a new save first drains the
previous write, so writer errors surface at the next `save`/`wait()`
in a fixed order.

Sharded checkpoints (`Checkpoint(sharded=True)`, `save_sharded`): a
ZeRO-sharded run saves the flat optimizer-state vectors as per-shard
save units (`optim-shard<i>of<n>.{npz,json}`, `shard_unit_name`), each
with its own integrity manifest, plus a checkpoint-level
`MANIFEST.json` written last. Every rank writes the shard units it
owns; rank 0 (the JAX package's process 0) also writes the model and
accumulator units and publishes the MANIFEST only after every shard's
unit manifest is on disk, then swaps the staging dir over the final
name. A kill at any point mid-save (the `ckpt_async_torn` fault kills
the writer after a shard unit) strands only the staging dir, and its
error surfaces at the next `save()`/`wait()`. On load the shards are
verified and concatenated back into the full padded flat vectors, so a
checkpoint written at one world size resumes at another
(param_layout.adapt_flat_tree). Ranks share the checkpoint directory
(one filesystem). The format is the JAX package's both ways.

Not ported: the `checkpoint_save`/`checkpoint_load` events and the
save-time histogram, which wait for the training plane's telemetry
(ROADMAP.md queue A.9).
"""

from __future__ import annotations

import json
import logging
import os
import queue
import re
import shutil
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from bigdl_tpu_torch.utils import faults
from bigdl_tpu_torch.utils.table import Table, sort_key

logger = logging.getLogger("bigdl_tpu_torch.optim")

_SEP = "/"


def _rank() -> int:
    """This process's rank (the JAX package's process index)."""
    return dist.get_rank() if dist.is_initialized() else 0


class CheckpointCorruptError(Exception):
    """A checkpoint directory failed integrity verification (truncated
    npz, checksum mismatch, missing array, unreadable manifest)."""


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _flatten(tree):
    """Flatten to {path: leaf}; records structure for exact rebuild."""
    leaves: Dict[str, Any] = {}

    def rec(node, path):
        if isinstance(node, dict):
            struct = {"__kind__": "dict",
                      "keys": sorted(node.keys(), key=sort_key),
                      "table": type(node).__name__ == "Table"}
            struct["children"] = [
                rec(node[k], path + [str(k)]) for k in struct["keys"]]
            struct["key_types"] = [type(k).__name__ for k in struct["keys"]]
            return struct
        if isinstance(node, (list, tuple)):
            struct = {"__kind__": "list" if isinstance(node, list) else "tuple",
                      "children": [rec(v, path + [str(i)])
                                   for i, v in enumerate(node)]}
            return struct
        if node is None:
            return {"__kind__": "none"}
        arr = np.asarray(node)
        key = _SEP.join(path) or "__root__"
        leaves[key] = arr
        return {"__kind__": "leaf", "key": key, "dtype": str(arr.dtype)}

    structure = rec(tree, [])
    return leaves, structure


def _unflatten(structure, leaves, as_torch: bool = True):
    def rec(s):
        kind = s["__kind__"]
        if kind == "none":
            return None
        if kind == "leaf":
            arr = leaves[s["key"]]
            return torch.from_numpy(np.array(arr)) if as_torch else arr
        if kind in ("list", "tuple"):
            vals = [rec(c) for c in s["children"]]
            return vals if kind == "list" else tuple(vals)
        keys = []
        for k, t in zip(s["keys"], s.get("key_types", ["str"] * len(s["keys"]))):
            keys.append(int(k) if t == "int" else k)
        d = Table() if s.get("table") else {}
        for k, c in zip(keys, s["children"]):
            d[k] = rec(c)
        return d

    return rec(structure)


def _host_tree(tree, path=()):
    """The tree with every tensor leaf as a host numpy array. numpy has
    no bfloat16 (without `ml_dtypes`), so a bf16 leaf is refused by
    name rather than written in a format the JAX package cannot read."""
    if isinstance(tree, dict):
        out = type(tree)()
        for k, v in tree.items():
            out[k] = _host_tree(v, path + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_tree(v, path + (i,))
                          for i, v in enumerate(tree))
    if isinstance(tree, torch.Tensor):
        if tree.dtype == torch.bfloat16:
            raise ValueError(
                f"checkpoint leaf {'/'.join(map(str, path)) or '<root>'} "
                "is bfloat16, which numpy cannot hold; keep master "
                "weights, optimizer slots and module state in float32")
        return tree.detach().to("cpu", copy=True).numpy()
    return tree


def save_pytree(directory: str, name: str, tree: Any,
                metadata: Optional[Dict] = None,
                only_host0: bool = False) -> str:
    if only_host0 and _rank() != 0:
        return os.path.join(directory, name)
    os.makedirs(directory, exist_ok=True)
    leaves, structure = _flatten(_host_tree(tree))
    npz_path = os.path.join(directory, f"{name}.npz")
    json_path = os.path.join(directory, f"{name}.json")
    np.savez(npz_path, **leaves)
    # the .json is the unit's completion marker (sharded saves await
    # its existence across ranks before publishing), so it must appear
    # atomically — a bare open('w') would be visible while still empty
    tmp_path = json_path + ".tmp"
    with open(tmp_path, "w") as f:
        json.dump({"structure": structure, "metadata": metadata or {},
                   "format": 2,
                   "checksums": {k: _crc(v) for k, v in leaves.items()},
                   "saved_at": time.time()}, f)
    os.rename(tmp_path, json_path)
    return os.path.join(directory, name)


def load_pytree(directory: str, name: str, as_torch: bool = True,
                verify: bool = True) -> Tuple[Any, Dict]:
    """Load one save unit; `verify` (default) re-checks every array's
    crc32 against the manifest and raises CheckpointCorruptError on any
    damage. Manifest parse failures and unreadable or truncated npz
    files raise CheckpointCorruptError too (missing files stay
    FileNotFoundError — absent and corrupt are different conditions)."""
    npz_path = os.path.join(directory, f"{name}.npz")
    json_path = os.path.join(directory, f"{name}.json")
    try:
        with open(json_path) as f:
            manifest = json.load(f)
    except FileNotFoundError:
        raise
    except (ValueError, OSError) as e:
        raise CheckpointCorruptError(
            f"unreadable manifest {json_path}: {e}") from e
    if not os.path.exists(npz_path):
        raise FileNotFoundError(npz_path)
    try:
        with np.load(npz_path) as z:
            leaves = {k: z[k] for k in z.files}
    except Exception as e:  # truncated zip, bad magic, short member...
        raise CheckpointCorruptError(
            f"unreadable array file {npz_path}: {e}") from e
    if verify:
        checksums = manifest.get("checksums")
        expected = _manifest_keys(manifest.get("structure", {}))
        missing = expected - set(leaves)
        if missing:
            raise CheckpointCorruptError(
                f"{npz_path}: missing arrays {sorted(missing)[:4]}")
        if checksums is not None:
            for k in expected:
                if checksums.get(k) != _crc(leaves[k]):
                    raise CheckpointCorruptError(
                        f"{npz_path}: checksum mismatch for {k!r}")
    tree = _unflatten(manifest["structure"], leaves, as_torch=as_torch)
    return tree, manifest.get("metadata", {})


def _manifest_keys(structure) -> set:
    """All leaf npz keys a manifest's structure references."""
    keys = set()

    def rec(s):
        kind = s.get("__kind__")
        if kind == "leaf":
            keys.add(s["key"])
        elif kind in ("dict", "list", "tuple"):
            for c in s["children"]:
                rec(c)

    if structure:
        rec(structure)
    return keys


def verify_pytree(directory: str, name: str) -> None:
    """Raise CheckpointCorruptError/FileNotFoundError unless the save
    unit `<directory>/<name>` fully verifies (reads every array)."""
    load_pytree(directory, name, as_torch=False, verify=True)


def shard_unit_name(index: int, nshards: int) -> str:
    """Save-unit name of shard `index` of `nshards`
    (`optim-shard003of008`)."""
    return f"optim-shard{index:03d}of{nshards:03d}"


class _AsyncSaver:
    """One daemon writer thread, one write in flight: `submit` first
    drains the previous write, then hands over the new snapshot. At
    most two host snapshots are alive (the one being written, the one
    just taken). Draining at submit also makes error surfacing
    deterministic: a failed background save is re-raised at the next
    `submit()`/`wait()`, never reordered behind a later write."""

    def __init__(self):
        self._queue: "queue.Queue" = queue.Queue(maxsize=1)
        self._errors: List[BaseException] = []
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    def _loop(self):
        while True:
            fn = self._queue.get()
            try:
                fn()
            except BaseException as e:  # surfaced at submit()/wait()
                with self._lock:
                    self._errors.append(e)
            finally:
                # drop the closure before signalling completion: it
                # holds the full host snapshot
                fn = None
                self._queue.task_done()

    def raise_pending(self) -> None:
        with self._lock:
            if self._errors:
                raise self._errors.pop(0)

    def submit(self, fn) -> None:
        self._queue.join()  # drain the in-flight write (see docstring)
        self.raise_pending()
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="bigdl-ckpt-writer")
            self._thread.start()
        self._queue.put(fn)

    def wait(self) -> None:
        self._queue.join()
        self.raise_pending()


class Checkpoint:
    """Numbered training checkpoints with latest-discovery (reference:
    DistriOptimizer's checkpointPath + getLatestFile).

    `sharded` marks the intent to save per-shard units (the training
    loops consult it to route through `save_sharded`); `async_save`
    moves the disk writes of both formats onto a background thread (the
    host snapshot happens on the caller's thread, the I/O does not).
    Either way `load()` reads both formats."""

    MODEL = "model"
    OPTIM = "optim"
    ACCUM = "accum"
    MARKER = "COMPLETE"
    MANIFEST = "MANIFEST.json"

    def __init__(self, path: str, sharded: bool = False,
                 async_save: bool = False):
        self.path = path
        self.sharded = sharded
        self.async_save = async_save
        os.makedirs(path, exist_ok=True)
        # last directory load() actually used — keeps load_accum() on
        # the same checkpoint when load() fell back past a corrupt one
        self._last_loaded: Optional[str] = None
        # directories skipped as corrupt, newest first
        self.corrupt_skipped: List[str] = []
        self._saver: Optional[_AsyncSaver] = None

    # ------------------------------------------------------------- async
    def wait(self) -> None:
        """Block until every pending background save has landed;
        re-raises the first stored writer error. The training loop
        calls this at the end of a run and before any checkpoint
        load."""
        if self._saver is not None:
            self._saver.wait()

    def _dispatch(self, write_fn) -> None:
        if self.async_save:
            if self._saver is None:
                self._saver = _AsyncSaver()
            self._saver.submit(write_fn)
        else:
            write_fn()

    @staticmethod
    def _host_snapshot(tree):
        """Host-numpy copy taken on the caller's thread, before the
        write is queued: the training loop updates the live tensors in
        place the moment save() returns."""
        if tree is None:
            return None
        return _host_tree(tree)

    # -------------------------------------------------------------- save
    def save(self, step: int, model_variables: Any, optim_state: Any,
             train_state: Optional[Dict] = None,
             optim_meta: Optional[Dict] = None,
             accum_state: Optional[Any] = None) -> str:
        """`accum_state`: a pending gradient-accumulation cycle
        ({'g_acc': ..., 'micro_n': n}) — saved so a mid-cycle checkpoint
        resumes the cycle instead of dropping the partial gradients."""
        d = os.path.join(self.path, f"checkpoint-{step}")
        if _rank() != 0:
            # the full format is replicated: rank 0 writes for everyone
            return d
        model_h = self._host_snapshot(model_variables)
        optim_h = self._host_snapshot(optim_state)
        accum_h = self._host_snapshot(accum_state)
        self._dispatch(lambda: self._write_full(
            d, step, model_h, optim_h, train_state, optim_meta, accum_h))
        return d

    def _write_full(self, d: str, step: int, model_h, optim_h,
                    train_state, optim_meta, accum_h) -> None:
        # atomic publish: write everything into a .inprogress staging
        # dir, then rename over the final name; latest() never matches
        # the staging or the .old name
        plan = faults.get_plan()
        tmp = d + ".inprogress"
        old = d + ".old"
        for leftover in (tmp, old):
            if os.path.isdir(leftover):
                shutil.rmtree(leftover)
        save_pytree(tmp, self.MODEL, model_h,
                    metadata={"train_state": train_state or {}})
        if plan.fires("ckpt_torn", step):
            # crash-mid-write model: the staging dir stays behind with
            # only the model unit written, never published
            raise faults.FaultInjected(
                f"injected fault ckpt_torn@{step}: save aborted "
                f"mid-write, staging left at {tmp}")
        save_pytree(tmp, self.OPTIM, optim_h, metadata=optim_meta)
        if accum_h is not None:
            save_pytree(tmp, self.ACCUM, accum_h)
        with open(os.path.join(tmp, self.MARKER), "w") as f:
            f.write("complete")
        # the reused dir moves aside in one rename, the staging dir
        # takes its name in another, and only then is the old content
        # deleted
        if os.path.isdir(d):
            os.rename(d, old)
        os.rename(tmp, d)
        if os.path.isdir(old):
            shutil.rmtree(old)
        if plan.fires("ckpt_corrupt", step):
            # bit-rot model: the publish succeeded, the bytes did not
            # survive — load() must detect this and fall back
            faults.corrupt_file(os.path.join(d, f"{self.MODEL}.npz"))

    # ------------------------------------------------------ sharded save
    def save_sharded(self, step: int, model_variables: Any,
                     shards: Dict[int, Any], nshards: int,
                     train_state: Optional[Dict] = None,
                     optim_meta: Optional[Dict] = None,
                     accum_state: Optional[Any] = None) -> str:
        """Save a ZeRO-sharded checkpoint: per-shard optimizer-state
        units + a checkpoint-level MANIFEST published last.

        `shards` maps shard index -> that shard's slot tree; each rank
        passes only the shards it owns. Rank 0 also writes the model
        (`model_variables`, the full tree; other ranks may pass None)
        and accumulator units and, once every shard's unit manifest is
        on disk, the MANIFEST. `optim_meta` carries the flat-layout
        fields (layout/num_shards/total/padded) of elastic resume."""
        d = os.path.join(self.path, f"checkpoint-{step}")
        primary = _rank() == 0
        model_h = self._host_snapshot(model_variables) if primary else None
        accum_h = self._host_snapshot(accum_state) if primary else None
        shards_h = {int(i): self._host_snapshot(t)
                    for i, t in sorted(shards.items())}
        self._dispatch(lambda: self._write_sharded(
            d, step, model_h, shards_h, int(nshards), train_state,
            optim_meta, accum_h, primary))
        return d

    @staticmethod
    def _await(predicate, timeout_s: float = 120.0, what: str = "") -> None:
        deadline = time.monotonic() + timeout_s
        while not predicate():
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"sharded checkpoint coordination timed out: {what}")
            time.sleep(0.02)

    def _write_sharded(self, d: str, step: int, model_h, shards_h,
                       nshards: int, train_state, optim_meta, accum_h,
                       primary: bool) -> None:
        plan = faults.get_plan()
        staging = d + ".inprogress"
        old = d + ".old"
        if primary:
            # staging-then-swap, like _write_full; a leftover same-step
            # staging dir from a crashed run is adopted, not deleted: a
            # rank that raced ahead may already be writing into it, and
            # a deterministic replay writes the same bytes
            if os.path.isdir(old):
                shutil.rmtree(old)
            os.makedirs(staging, exist_ok=True)
            save_pytree(staging, self.MODEL, model_h,
                        metadata={"train_state": train_state or {}})
            if accum_h is not None:
                save_pytree(staging, self.ACCUM, accum_h)
        else:
            # the other ranks wait for rank 0 to open the staging dir
            self._await(
                lambda: os.path.isdir(staging),
                what=f"host waiting for {staging} to open for writing")
        for i, tree in shards_h.items():
            save_pytree(staging, shard_unit_name(i, nshards), tree,
                        metadata={"shard": i, "nshards": nshards,
                                  **(optim_meta or {})})
            if plan.fires("ckpt_async_torn", step):
                # kill-during-background-save model: the writer dies
                # with units in staging and no published dir — latest()
                # never surfaces it, and the error surfaces at the next
                # save()/wait()
                raise faults.FaultInjected(
                    f"injected fault ckpt_async_torn@{step}: writer "
                    f"killed mid-save, torn units left in {staging}")
        if primary:
            self._await(
                lambda: all(os.path.exists(os.path.join(
                    staging, shard_unit_name(i, nshards) + ".json"))
                    for i in range(nshards)),
                what=f"waiting for all {nshards} shard units in "
                     f"{staging}")
            tmp = os.path.join(staging, self.MANIFEST + ".tmp")
            with open(tmp, "w") as f:
                json.dump({"format": 3, "step": int(step),
                           "nshards": nshards,
                           "optim_meta": optim_meta or {},
                           "units": [shard_unit_name(i, nshards)
                                     for i in range(nshards)],
                           "has_accum": accum_h is not None,
                           "saved_at": time.time()}, f)
            os.rename(tmp, os.path.join(staging, self.MANIFEST))
            # the publish: swap staging over the final name
            if os.path.isdir(d):
                os.rename(d, old)
            os.rename(staging, d)
            if os.path.isdir(old):
                shutil.rmtree(old)
            if plan.fires("ckpt_corrupt", step):
                # bit-rot one published shard: load() must catch the
                # crc mismatch and fall back
                faults.corrupt_file(os.path.join(
                    d, shard_unit_name(nshards // 2, nshards) + ".npz"))

    def load_accum(self, directory: Optional[str] = None):
        """The pending accumulation cycle saved alongside a checkpoint,
        or None (update-boundary checkpoint). With no explicit
        directory, follows the checkpoint the last `load()` actually
        used — not `latest()` — so a load that fell back past a corrupt
        newest checkpoint pairs with that older dir's cycle. A corrupt
        accumulator is dropped with a warning (None): the cycle
        restarts, which is safe."""
        d = directory or self._last_loaded or self.latest()
        if d is None or not os.path.exists(
                os.path.join(d, f"{self.ACCUM}.json")):
            return None
        try:
            tree, _ = load_pytree(d, self.ACCUM)
        except CheckpointCorruptError as e:
            logger.warning("corrupt accumulator in %s (%s); restarting "
                           "the accumulation cycle", d, e)
            return None
        return tree

    def candidates(self, allow_unmarked: bool = True) -> List[str]:
        """Complete checkpoint dirs, newest step first. Completeness is
        the cheap structural check only (marker, both manifests, or a
        sharded MANIFEST); content integrity is verified by load(). A
        sharded save whose writer died mid-write leaves only a
        `checkpoint-N.inprogress` staging dir, which never matches."""
        if not os.path.isdir(self.path):
            return []
        found = []
        for entry in os.listdir(self.path):
            m = re.fullmatch(r"checkpoint-(\d+)", entry)
            if not m:
                continue
            d = os.path.join(self.path, entry)
            complete = (os.path.exists(os.path.join(d, self.MARKER))
                        or os.path.exists(os.path.join(d, self.MANIFEST))
                        or (allow_unmarked
                            and os.path.exists(
                                os.path.join(d, f"{self.OPTIM}.json"))
                            and os.path.exists(
                                os.path.join(d, f"{self.MODEL}.json"))))
            if complete:
                found.append((int(m.group(1)), d))
        return [d for _, d in sorted(found, reverse=True)]

    def latest(self, allow_unmarked: bool = True) -> Optional[str]:
        """Newest complete checkpoint dir. The marker-less
        both-manifests fallback (default on) admits checkpoints from
        the JAX package's pre-marker versions; `allow_unmarked=False`
        trusts only marked dirs. Deeper damage is caught by load()."""
        cands = self.candidates(allow_unmarked)
        return cands[0] if cands else None

    def _load_dir(self, d: str, with_optim_meta: bool):
        if os.path.exists(os.path.join(d, self.MANIFEST)):
            return self._load_sharded_dir(d, with_optim_meta)
        model_variables, meta = load_pytree(d, self.MODEL)
        optim_state, optim_meta = load_pytree(d, self.OPTIM)
        self._last_loaded = d
        if with_optim_meta:
            return (model_variables, optim_state, meta.get("train_state", {}),
                    optim_meta)
        return model_variables, optim_state, meta.get("train_state", {})

    def _load_sharded_dir(self, d: str, with_optim_meta: bool):
        """Verify and concatenate the per-shard flat slot slices back
        into the full (padded,) vectors. The result carries the
        save-time layout (optim_meta from the MANIFEST); another world
        size re-pads through param_layout.adapt_flat_tree. A damaged or
        missing shard raises (CheckpointCorruptError /
        FileNotFoundError), which load() turns into a fallback."""
        from bigdl_tpu_torch.models.convert import tree_leaves, tree_map
        from bigdl_tpu_torch.parallel.param_layout import concat_shard_trees

        mpath = os.path.join(d, self.MANIFEST)
        try:
            with open(mpath) as f:
                man = json.load(f)
            nshards = int(man["nshards"])
        except (ValueError, OSError, KeyError, TypeError) as e:
            # a manifest that parses but lost its fields falls back like
            # an unreadable one
            raise CheckpointCorruptError(
                f"unreadable sharded manifest {mpath}: {e}") from e
        model_variables, meta = load_pytree(d, self.MODEL)
        parts = [load_pytree(d, shard_unit_name(i, nshards),
                             as_torch=False)[0] for i in range(nshards)]
        if parts and tree_leaves(parts[0]):
            optim_state = tree_map(torch.from_numpy,
                                   concat_shard_trees(parts))
        else:  # slot-less method (plain SGD): every shard tree is empty
            optim_state = parts[0] if parts else {}
        self._last_loaded = d
        optim_meta = man.get("optim_meta") or {}
        if with_optim_meta:
            return (model_variables, optim_state,
                    meta.get("train_state", {}), optim_meta)
        return model_variables, optim_state, meta.get("train_state", {})

    def load(self, directory: Optional[str] = None,
             with_optim_meta: bool = False, allow_unmarked: bool = True):
        """Load a checkpoint, verifying every array's checksum.

        With an explicit `directory`, damage raises (the caller asked
        for that checkpoint). With none, candidates are tried newest
        first and any that fails verification is skipped with a
        warning, falling back to the newest checkpoint that verifies.
        Only when no candidate verifies does this raise
        (FileNotFoundError if there were no candidates at all, else
        CheckpointCorruptError)."""
        if directory is not None:
            return self._load_dir(directory, with_optim_meta)
        cands = self.candidates(allow_unmarked)
        if not cands:
            raise FileNotFoundError(f"no checkpoint under {self.path}")
        last_err: Optional[Exception] = None
        for d in cands:
            try:
                return self._load_dir(d, with_optim_meta)
            except (CheckpointCorruptError, FileNotFoundError) as e:
                self.corrupt_skipped.append(d)
                last_err = e
                logger.warning(
                    "checkpoint %s failed verification (%s); falling "
                    "back to the previous checkpoint", d, e)
        raise CheckpointCorruptError(
            f"no valid checkpoint under {self.path}: all "
            f"{len(cands)} candidates failed verification "
            f"(last: {last_err})")
