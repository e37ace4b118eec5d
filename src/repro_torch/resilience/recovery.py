"""Crash/preemption recovery: snapshots, write-ahead journal, respawn.

PyTorch twin of :mod:`repro.resilience.recovery`, with the same on-disk
format, so each package reads the snapshots and journals the other wrote.
Three cooperating pieces:

* **Atomic directory publish** — the old copy of a step is renamed
  *aside* before the new one is published, so there is no window in which
  neither exists.  Readers tolerate stray ``.tmp-*`` / ``.old-*`` dirs
  left by a crash, and a missing final dir is recovered from its ``.old``.

* **Structure-preserving snapshots** — ``save_snapshot`` serializes an
  arbitrary tree of dict/list/tuple/str/int/float/bool/None with array
  leaves (tensors or numpy arrays) hoisted into one ``.npz`` (bf16 as
  uint16 views plus a dtype tag), and ``load_snapshot`` rebuilds the
  identical structure with CPU tensor leaves — no template required.
  Tensors become numpy arrays only at the file boundary.  Arrays are
  *logical* (unsharded), so a snapshot written at lanes=L restores onto
  any other lane count (elastic resume).

* **Write-ahead result journal** — an append-only, fsync'd JSONL file of
  emitted results.  Every line carries its own CRC32, so replay stops
  cleanly at a torn tail (a crash mid-append).  A resumed run replays the
  journal to re-emit pre-crash results and suppresses their indices:
  exactly-once emission across restarts.

``run_to_completion`` is the kill-and-respawn harness: it re-execs a
child command while it exits with ``PREEMPTED_EXIT`` (the seeded
process-fault exit code used by ``FaultPlan.preempt_hook``).
"""
from __future__ import annotations

import base64
import dataclasses
import io
import json
import os
import shutil
import subprocess
import zlib
from typing import Any, Callable, Iterator, List, Optional

import numpy as np
import torch

# exit code a seeded preemption uses (os._exit — no finally blocks run,
# like a SIGKILL'd spot instance); the respawn harness treats it as
# "preempted, restart", anything else as a real failure.
PREEMPTED_EXIT = 17


class PreemptionError(RuntimeError):
    """Raised by ``FaultPlan.preempt_hook(mode="raise")`` — the
    in-process stand-in for a kill, used by tests that resume inside
    the same interpreter."""


# ---------------------------------------------------------------------------
# atomic directory publish
# ---------------------------------------------------------------------------

def fresh_tmp_dir(parent: str, tag: str) -> str:
    """Create and return an empty ``<parent>/.tmp-<tag>`` staging dir."""
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f".tmp-{tag}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    return tmp


def publish_dir(tmp: str, final: str) -> str:
    """Atomically publish staging dir ``tmp`` as ``final``.

    Crash-safe at every point: if ``final`` already exists it is renamed
    aside to ``.old-<name>`` first, then ``tmp`` is renamed in, then the
    old copy is deleted.  A crash between any two steps leaves either
    the old or the new copy (or both) on disk — never neither.  Readers
    (``latest_step_in`` / ``recover_stray``) resolve leftovers.
    """
    parent = os.path.dirname(final)
    name = os.path.basename(final)
    old = os.path.join(parent, f".old-{name}")
    if os.path.exists(old):  # leftover from an earlier crash
        shutil.rmtree(old)
    had_prev = os.path.exists(final)
    if had_prev:
        os.replace(final, old)  # rename aside, NOT rmtree: old stays whole
    os.replace(tmp, final)      # atomic publish
    if had_prev:
        shutil.rmtree(old)      # only now is the old copy unreachable
    return final


def sweep_strays(parent: str) -> None:
    """Best-effort removal of ``.tmp-*`` / ``.old-*`` crash leftovers.

    ``.old-<name>`` dirs are only removed when ``<name>`` exists (the
    publish completed); otherwise they are the sole surviving copy and
    are recovered by promotion instead of deletion.
    """
    if not os.path.isdir(parent):
        return
    for d in os.listdir(parent):
        path = os.path.join(parent, d)
        if d.startswith(".tmp-"):
            shutil.rmtree(path, ignore_errors=True)
        elif d.startswith(".old-"):
            final = os.path.join(parent, d[len(".old-"):])
            if os.path.exists(final):
                shutil.rmtree(path, ignore_errors=True)
            else:  # crash after rename-aside, before publish: promote
                os.replace(path, final)


def list_steps(parent: str, prefix: str = "step_") -> List[int]:
    """Published step numbers under ``parent``, stray-tolerant."""
    if not os.path.isdir(parent):
        return []
    sweep_strays(parent)
    out = []
    for d in os.listdir(parent):
        if d.startswith(prefix) and not d.startswith("."):
            try:
                out.append(int(d[len(prefix):]))
            except ValueError:
                continue
    return sorted(out)


# ---------------------------------------------------------------------------
# structure-preserving snapshots
# ---------------------------------------------------------------------------

_LEAF = "__leaf__"
_TUPLE = "__tuple__"


def _is_array(x: Any) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic))


def _file_array(x) -> tuple:
    """An array leaf as it goes to disk: ``(numpy array, is_bf16)``, bf16
    (a torch tensor, or a numpy array of ml_dtypes' bfloat16) as a uint16
    view."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(
                np.uint16), True
        return t.numpy(), False
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16), True
    return arr, False


def _tensor(arr: np.ndarray, bf16: bool) -> torch.Tensor:
    """A leaf read from disk as a CPU tensor (bf16 from its uint16 view)."""
    if bf16:
        return torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _encode(obj: Any, leaves: List[np.ndarray]) -> Any:
    if _is_array(obj):
        idx = len(leaves)
        leaves.append(obj)
        return {_LEAF: idx}
    if isinstance(obj, dict):
        return {str(k): _encode(v, leaves) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return {_TUPLE: [_encode(v, leaves) for v in obj]}
    if isinstance(obj, list):
        return [_encode(v, leaves) for v in obj]
    if obj is None or isinstance(obj, (bool, str)):
        return obj
    if isinstance(obj, (int, float)):
        return obj.item() if isinstance(obj, np.generic) else obj
    raise TypeError(f"snapshot cannot serialize {type(obj).__name__}")


def _decode(obj: Any, leaves: dict) -> Any:
    if isinstance(obj, dict):
        if set(obj) == {_LEAF}:
            return leaves[obj[_LEAF]]
        if set(obj) == {_TUPLE}:
            return tuple(_decode(v, leaves) for v in obj[_TUPLE])
        return {k: _decode(v, leaves) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(v, leaves) for v in obj]
    return obj


def save_snapshot(snap_dir: str, step: int, tree: Any, *,
                  keep: int = 2) -> str:
    """Write ``tree`` (dicts/lists/tuples/scalars + array leaves) as the
    atomically-published ``<snap_dir>/step_<step>``.  Keeps the newest
    ``keep`` snapshots."""
    tmp = fresh_tmp_dir(snap_dir, str(step))
    leaves: List[Any] = []
    skeleton = _encode(tree, leaves)
    arrays, dtypes = {}, {}
    for i, leaf in enumerate(leaves):
        arr, bf16 = _file_array(leaf)
        dtypes[str(i)] = "bfloat16" if bf16 else str(arr.dtype)
        arrays[str(i)] = arr
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {"step": step, "n_leaves": len(leaves), "dtypes": dtypes,
                "skeleton": skeleton}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    final = publish_dir(tmp, os.path.join(snap_dir, f"step_{step:010d}"))
    for s in list_steps(snap_dir)[:-keep]:
        shutil.rmtree(os.path.join(snap_dir, f"step_{s:010d}"),
                      ignore_errors=True)
    return final


def latest_snapshot_step(snap_dir: str) -> Optional[int]:
    steps = list_steps(snap_dir)
    return steps[-1] if steps else None


def load_snapshot(snap_dir: str, *, step: Optional[int] = None) -> Any:
    """Rebuild the tree written by ``save_snapshot`` (either package's),
    array leaves as CPU tensors.  Returns ``None`` when no snapshot has
    been published yet (a fresh run)."""
    if step is None:
        step = latest_snapshot_step(snap_dir)
        if step is None:
            return None
    path = os.path.join(snap_dir, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "arrays.npz"))
    leaves = {}
    for i in range(manifest["n_leaves"]):
        leaves[i] = _tensor(data[str(i)],
                            manifest["dtypes"][str(i)] == "bfloat16")
    return _decode(manifest["skeleton"], leaves)


# ---------------------------------------------------------------------------
# write-ahead result journal
# ---------------------------------------------------------------------------

_ND = "__nd__"


def _to_jsonable(v: Any) -> Any:
    if v is None or isinstance(v, (bool, str)):
        return v
    if _is_array(v):
        arr, bf16 = _file_array(v)
        buf = io.BytesIO()
        np.save(buf, arr, allow_pickle=False)
        rec = {_ND: base64.b64encode(buf.getvalue()).decode("ascii")}
        if bf16:
            rec["bf16"] = True
        return rec
    if isinstance(v, (int, float)):
        return v.item() if isinstance(v, np.generic) else v
    if isinstance(v, (list, tuple)):
        return [_to_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _to_jsonable(x) for k, x in v.items()}
    raise TypeError(f"journal cannot serialize {type(v).__name__}")


def _from_jsonable(v: Any) -> Any:
    if isinstance(v, dict):
        if _ND in v:
            arr = np.load(io.BytesIO(base64.b64decode(v[_ND])),
                          allow_pickle=False)
            return _tensor(arr, bool(v.get("bf16")))
        return {k: _from_jsonable(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_from_jsonable(x) for x in v]
    return v


class Journal:
    """Append-only, fsync'd, CRC-framed JSONL write-ahead log (array
    values come back from ``replay`` as CPU tensors).

    Each line is ``<crc32 hex8> <json>\\n`` where the CRC covers the json
    text.  ``replay`` yields decoded records up to (not including) the
    first torn or corrupt line — a crash mid-``append`` loses at most the
    record being written, which by WAL ordering was not yet emitted.
    """

    def __init__(self, path: str, *, fsync: bool = True):
        self.path = path
        self.fsync = fsync
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fh = open(path, "ab")

    def append(self, record: dict) -> None:
        text = json.dumps(_to_jsonable(record), separators=(",", ":"))
        crc = zlib.crc32(text.encode("utf-8")) & 0xFFFFFFFF
        self._fh.write(f"{crc:08x} {text}\n".encode("utf-8"))
        self._fh.flush()
        if self.fsync:
            os.fsync(self._fh.fileno())

    def close(self) -> None:
        try:
            self._fh.close()
        except Exception:
            pass

    @staticmethod
    def replay(path: str) -> Iterator[dict]:
        if not os.path.exists(path):
            return
        with open(path, "rb") as fh:
            for raw in fh:
                line = raw.decode("utf-8", errors="replace")
                if not line.endswith("\n"):
                    return  # torn tail: crash mid-append
                body = line[:-1]
                if len(body) < 10 or body[8] != " ":
                    return
                text = body[9:]
                try:
                    if int(body[:8], 16) != (zlib.crc32(text.encode("utf-8"))
                                             & 0xFFFFFFFF):
                        return
                    rec = json.loads(text)
                except (ValueError, json.JSONDecodeError):
                    return
                yield _from_jsonable(rec)


# ---------------------------------------------------------------------------
# recovery config + respawn harness
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RecoveryConfig:
    """Where and how often an engine persists its recovery state.

    * ``dir``      — root; snapshots under ``<dir>/snapshots``, journal at
                     ``<dir>/journal.jsonl``.
    * ``snapshot_every`` — snapshot cadence in segments (RPO: at most this
                     many segments of *compute* are redone on resume; no
                     emitted result is ever redone thanks to the journal).
    * ``fsync``    — fsync each journal append (turn off only in tests).
    * ``keep``     — retained snapshot count.
    """
    dir: str
    snapshot_every: int = 1
    fsync: bool = True
    keep: int = 2

    @property
    def snap_dir(self) -> str:
        return os.path.join(self.dir, "snapshots")

    @property
    def journal_path(self) -> str:
        return os.path.join(self.dir, "journal.jsonl")


def run_to_completion(argv: List[str], *, max_restarts: int = 8,
                      env: Optional[dict] = None,
                      on_restart: Optional[Callable[[int], None]] = None,
                      timeout: Optional[float] = None) -> int:
    """Run ``argv`` as a subprocess, respawning while it exits with
    ``PREEMPTED_EXIT``.  Returns the number of restarts on success;
    raises on any other non-zero exit or when ``max_restarts`` is hit.

    This is the test/bench stand-in for a cluster scheduler restarting a
    preempted worker: the child is expected to pick ``--resume`` state up
    from its recovery dir on each respawn.
    """
    restarts = 0
    while True:
        proc = subprocess.run(argv, env=env, timeout=timeout)
        if proc.returncode == 0:
            return restarts
        if proc.returncode != PREEMPTED_EXIT:
            raise RuntimeError(
                f"child failed with exit {proc.returncode} (not a "
                f"preemption): {' '.join(argv)}")
        restarts += 1
        if restarts > max_restarts:
            raise RuntimeError(
                f"child still preempting after {max_restarts} restarts")
        if on_restart is not None:
            on_restart(restarts)
