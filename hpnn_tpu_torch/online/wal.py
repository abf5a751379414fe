"""Promotion write-ahead log: crash-safe durability for train-while-serve
(a copy of ``hpnn_tpu/online/wal.py`` over the port's checkpoint
format, which is the JAX package's byte for byte: a checkpoint written
by either package restores bitwise in the other).

ROADMAP item 3's persistence gap: promotions live only in the process
(``Registry.install``), so ``kill -9`` discards every learned version.
With ``HPNN_WAL_DIR=<dir>`` set, each promotion (and rollback) is made
durable in two fsync'd steps, checkpoint-before-log:

1. an atomic bitwise weight checkpoint
   (``<dir>/<kernel>.v<version>.ckpt`` via
   :mod:`hpnn_tpu_torch.fileio.checkpoint` — temp file + fsync + rename,
   version recorded in the header);
2. an appended-and-fsync'd JSONL record in ``<dir>/promotions.wal``
   referencing the checkpoint by name and by the registry-compatible
   ``(st_mtime_ns, st_size)`` staleness signature.

Because the checkpoint lands before its WAL record, a record always
points at a durable file; a crash between the two steps leaves an
orphan checkpoint that pruning eventually collects.  Replay
(:meth:`PromotionWAL.restore`) walks records newest-first and skips
any whose checkpoint is missing, torn, or stat-mismatched — so the
restart resumes the *last committed* version bitwise, never a partial
write.  ``OnlineSession.add_kernel`` replays automatically; the
restored entry is registered with the checkpoint's path/sig, so the
registry's hot-reload staleness machinery keeps working on it.

Like every knob family, unset costs nothing: the promoter holds
``wal=None`` and never touches the filesystem (byte-frozen stdout
proved in ``tools/check_tokens.py``).  Catalog: docs/resilience.md.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

from hpnn_tpu_torch import obs
from hpnn_tpu_torch.fileio import checkpoint as ckpt_mod

ENV_KNOB = "HPNN_WAL_DIR"

WAL_NAME = "promotions.wal"


class WALError(Exception):
    pass


class PromotionWAL:
    """One directory holding ``promotions.wal`` plus per-version
    checkpoint files (``<kernel>.v<version>.ckpt``).  Checkpoints are
    per-version — not one rewritten file — so a torn latest still
    leaves the previous commit restorable; ``keep`` bounds how many
    versions per kernel stay on disk.  Thread-safe; one instance per
    process/dir."""

    def __init__(self, dir: str, *, keep: int = 3):
        self.dir = str(dir)
        self.path = os.path.join(self.dir, WAL_NAME)
        self.keep = max(1, int(keep))
        self._lock = obs.lockwatch.lock("online.wal")
        os.makedirs(self.dir, exist_ok=True)

    # ------------------------------------------------------------ write
    def commit(self, name: str, weights, *, version: int, model: str = "ann",
               reason: str = "promote", step: int = 0):
        """Durably record ``weights`` as kernel ``name``'s resident
        version.  Checkpoint first, WAL record second (write-ahead
        ordering).  Returns the WAL record dict."""
        ckpt = os.path.join(self.dir, f"{name}.v{int(version)}.ckpt")
        sig = ckpt_mod.dump_checkpoint(
            ckpt, name, weights, version=int(version), model=model,
            meta={"reason": reason, "step": int(step)})
        rec = {
            "ev": "wal.commit",
            "ts": round(time.time(), 6),
            "kernel": str(name),
            "version": int(version),
            "model": str(model),
            "reason": str(reason),
            "step": int(step),
            "ckpt": os.path.basename(ckpt),
            "sig": [int(sig[0]), int(sig[1])],
        }
        line = json.dumps(rec, sort_keys=True) + "\n"
        with self._lock:
            with open(self.path, "a", encoding="utf-8") as fp:
                fp.write(line)
                fp.flush()
                os.fsync(fp.fileno())
        self._prune(name, int(version))
        return rec

    def _prune(self, name: str, newest: int) -> None:
        """Drop checkpoints older than the ``keep`` newest versions of
        ``name`` (best-effort; the WAL records stay — replay skips a
        record whose file is gone)."""
        prefix = f"{name}.v"
        versions = []
        try:
            for fn in os.listdir(self.dir):
                if fn.startswith(prefix) and fn.endswith(".ckpt"):
                    try:
                        versions.append(int(fn[len(prefix):-5]))
                    except ValueError:
                        continue
        except OSError:
            return
        for v in sorted(versions, reverse=True)[self.keep:]:
            try:
                os.unlink(os.path.join(self.dir, f"{name}.v{v}.ckpt"))
            except OSError:
                pass

    # ------------------------------------------------------------ read
    def records(self) -> list[dict]:
        """All parseable WAL records, oldest first.  A torn tail line
        (crash mid-append) is skipped, not fatal."""
        out: list[dict] = []
        try:
            with open(self.path, "r", encoding="utf-8") as fp:
                for line in fp:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(rec, dict) and rec.get("kernel"):
                        out.append(rec)
        except OSError:
            return []
        return out

    def last_committed(self, name: str) -> dict | None:
        """Newest WAL record for ``name`` whose checkpoint is present,
        intact, and stat-matches the recorded signature."""
        for rec in reversed(self.records()):
            if rec.get("kernel") != name:
                continue
            path = os.path.join(self.dir, rec.get("ckpt", ""))
            try:
                st = os.stat(path)
            except OSError:
                continue
            sig = rec.get("sig")
            if (isinstance(sig, (list, tuple)) and len(sig) == 2
                    and [int(sig[0]), int(sig[1])]
                    != [st.st_mtime_ns, st.st_size]):
                obs.count("wal.skip", kernel=name, reason="sig")
                continue
            if not ckpt_mod.is_checkpoint(path):
                obs.count("wal.skip", kernel=name, reason="magic")
                continue
            return rec
        return None

    def restore(self, name: str):
        """-> ``(weights_tuple, record)`` for the last committed
        version of ``name``, or ``None``.  Walks back past torn
        checkpoints (integrity failures count ``wal.skip``)."""
        seen: set[str] = set()
        for rec in reversed(self.records()):
            if rec.get("kernel") != name:
                continue
            path = os.path.join(self.dir, rec.get("ckpt", ""))
            try:
                st = os.stat(path)
            except OSError:
                continue
            sig = rec.get("sig")
            if (isinstance(sig, (list, tuple)) and len(sig) == 2
                    and [int(sig[0]), int(sig[1])]
                    != [st.st_mtime_ns, st.st_size]):
                # the file on disk is not the one this record fsync'd
                # (rewritten or tampered with since the commit)
                if path not in seen:
                    obs.count("wal.skip", kernel=name, reason="sig")
                    seen.add(path)
                continue
            try:
                _, ws, header = ckpt_mod.load_checkpoint(path)
            except ckpt_mod.CheckpointError as exc:
                obs.count("wal.skip", kernel=name, reason="torn")
                print(f"hpnn wal: skipping torn checkpoint {path}: {exc}",
                      file=sys.stderr)
                seen.add(path)
                continue
            return tuple(ws), rec
        return None

    def names(self) -> list[str]:
        return sorted({rec["kernel"] for rec in self.records()})

    def doc(self) -> dict:
        recs = self.records()
        return {"dir": self.dir, "records": len(recs),
                "kernels": self.names()}


# ------------------------------------------------------------ env knob
# Memoized like every obs knob: None = unread, False = disarmed,
# PromotionWAL = armed.
_wal = None
_lock = threading.Lock()


def from_env():
    """The process-wide WAL from ``HPNN_WAL_DIR``, or ``None``."""
    global _wal
    with _lock:
        if _wal is None:
            d = os.environ.get(ENV_KNOB, "").strip()
            if not d:
                _wal = False
            else:
                try:
                    _wal = PromotionWAL(d)
                except OSError as exc:
                    print(f"hpnn wal: cannot use {d!r}: {exc}",
                          file=sys.stderr)
                    _wal = False
        return _wal or None


def enabled() -> bool:
    return from_env() is not None


def _reset_for_tests():
    global _wal
    with _lock:
        _wal = None
