"""Execution core: bucketed shapes, one captured forward per bucket (the
port of ``hpnn_tpu/serve/engine.py``).

A resident server meets arbitrary per-request row counts.  The engine
quantizes every batch to a small fixed menu of power-of-two row-count
**buckets** (default 4: ``max_batch / 2^3 … max_batch``, e.g.
8/16/32/64) and keeps exactly one cached forward per
``(kernel, version, bucket, dtype, policy)``.  Warmup fills the whole
menu at startup so steady-state serving never captures again — the
invariant the obs ``serve.compile`` counter proves.

Two dispatch modes, selected per engine (``HPNN_SERVE_MODE`` or the
``mode=`` argument; default by device):

* ``"compiled"`` (the ``cuda`` default) — the bucket's forward is the
  batched forward (``models/ann.py``/``models/snn.py`` ``run_batch``)
  over a padded ``(bucket, n_in)`` block, captured once as a CUDA graph
  behind one static input buffer: a dispatch copies the padded block
  into the buffer, replays the graph and copies the output out, under
  the graph's own lock (two threads replaying one graph would share the
  buffer).  It is the counterpart of the JAX engine's one AOT
  executable per bucket.  The forward is warmed up on a side stream
  before its capture.  Each graph has its own memory pool: the batchers
  of different kernels replay their graphs from their own threads, and
  in a shared pool one graph's replay could overwrite the output of
  another that is still being copied out.  Captures run under the
  engine lock in ``thread_local`` mode, while a lookup that finds its
  forward cached takes no lock, so other threads keep replaying their
  graphs meanwhile.  ``torch.cuda.graph``'s context synchronizes the
  card and empties the allocator's cache, which the allocator does not
  allow while another capture is underway, so every capture in the
  process (every engine's: a router's replicas share the process) also
  holds one module lock, ``_CAPTURE_LOCK``.  The cache it empties holds
  the private pools of the graphs :meth:`Engine.evict` dropped, so a
  capture hands them back to the card.  cuBLAS keeps a workspace (32
  MiB on an H100) for each capturing thread's handle on the side
  stream, for the process's life: a host bounds them by capturing from
  few threads (the tenant pager captures on the requesting thread at
  page-in, and refuses lazy captures on ``cuda``).  TF32 is off (the
  JAX engine's float32 matmul pin); under the ``bf16``/``int8`` policies
  bf16 products also keep their float32 reduction
  (``allow_bf16_reduced_precision_reduction = False``).  A failed
  capture or replay raises: there is no eager or CPU fallback.  On the
  CPU (tests) the same batched function runs eagerly.
* ``"parity"`` (the CPU default) — the bucket entry runs each row
  through the SAME per-sample ``model.run`` call the ``run_nn`` driver
  makes, on fresh tensors of the kernel's dtype on the engine's device,
  so served outputs are **bitwise-equal** to a direct per-row ``run``
  and a request's answer never depends on what it was coalesced with.

Both modes share the bucket menu, the cache-key discipline and the obs
counters.  On ``cuda`` the native compute dtype is
``runtime.compute_dtype`` (float32 unless ``HPNN_DTYPE`` says float64);
on the CPU it is the kernel's own dtype.  Host IO stays numpy in the
kernel's dtype.

**Low-precision serving** (compiled mode only): a per-kernel precision
policy — ``Entry.precision`` overriding ``HPNN_SERVE_DTYPE`` — runs the
forward in ``bf16``/``f32``/``f64``, or with int8 weights dequantized to
bf16 in the graph (``q.to(bf16) * scale``).  Weights are cast (or
quantized, :func:`quantize_weights`) ONCE per (kernel, version, policy)
onto the engine's device; the graph casts its input down and its output
back to the native dtype.  ``warmup`` measures each quantized kernel's
error against the CPU float64 per-row reference on a probe block (the
``numerics.quant_err`` gauge and the ``/healthz`` ``precision``
section).  Parity mode ignores the policy: its contract is bitwise.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time

import numpy as np
import torch

from hpnn_tpu_torch import chaos, obs, runtime
from hpnn_tpu_torch.models import ann, snn
from hpnn_tpu_torch.models import kernel as kernel_mod
from hpnn_tpu_torch.serve import compile_cache
from hpnn_tpu_torch.serve.registry import PRECISIONS, Entry, Registry

DEFAULT_MAX_BATCH = 64
DEFAULT_N_BUCKETS = 4
_MODES = ("parity", "compiled")
# "int8" = int8 weights dequantized to bf16 activations
_POLICY_DTYPE = {"bf16": torch.bfloat16, "int8": torch.bfloat16,
                 "f32": torch.float32, "f64": torch.float64}
# eager runs of a forward on a side stream before its capture
_WARMUP_RUNS = 3
# held by every capture in the process (see the module docstring)
_CAPTURE_LOCK = threading.Lock()


def quantize_weights(weights, *, bits: int = 8):
    """Symmetric per-tensor weight quantization: each layer matrix is
    mapped to ``round(w / scale)`` int8 (or narrower) with ``scale =
    absmax / (2^(bits-1) - 1)``.  Returns ``(quants, scales)`` —
    int8 numpy arrays and their per-layer float scales.  The serve
    path dequantizes inside the executable (``q * scale`` in bf16),
    so HBM holds 1 byte/weight; ``bits`` narrows the grid for the
    monotone-error test (fewer bits can only hurt)."""
    if not 2 <= bits <= 8:
        raise ValueError(f"bits must be in [2, 8], got {bits}")
    qmax = float(2 ** (bits - 1) - 1)
    quants, scales = [], []
    for w in weights:
        w = np.asarray(w, dtype=np.float64)
        absmax = float(np.max(np.abs(w)))
        scale = (absmax / qmax) if absmax > 0 else 1.0
        q = np.clip(np.rint(w / scale), -qmax, qmax).astype(np.int8)
        quants.append(q)
        scales.append(scale)
    return quants, scales


def fleet_key(entry: Entry) -> tuple:
    """The grouping key for fleet dispatch: two kernels can share one
    stacked executable iff they agree on (model, layer shapes, dtype).
    Version is deliberately absent — the fleet CACHE key carries each
    member's version, so a hot-reload regroups transparently."""
    shapes = tuple(tuple(int(d) for d in np.asarray(w).shape)
                   for w in entry.kernel.weights)
    return (entry.model, shapes,
            np.asarray(entry.kernel.weights[0]).dtype.str)


def bucket_menu(max_batch: int = DEFAULT_MAX_BATCH,
                n_buckets: int = DEFAULT_N_BUCKETS) -> tuple[int, ...]:
    """Ascending power-of-two bucket sizes ending at ``max_batch``
    (rounded up to a power of two), e.g. (8, 16, 32, 64)."""
    if max_batch < 1:
        raise ValueError("max_batch must be >= 1")
    top = 1
    while top < max_batch:
        top *= 2
    menu = []
    b = top
    for _ in range(max(1, int(n_buckets))):
        menu.append(b)
        if b == 1:
            break
        b //= 2
    return tuple(sorted(menu))


def bucket_for(menu: tuple[int, ...], rows: int) -> int:
    """Smallest bucket holding ``rows``; the largest when none does
    (the caller then chunks the batch)."""
    for b in menu:
        if rows <= b:
            return b
    return menu[-1]


def _model_of(entry: Entry):
    return snn if entry.model == "snn" else ann


def batch_forward(model, weights, xs, cdt=None, scales=None):
    """The batched forward of one bucket, the body every compiled-mode
    forward runs (captured on ``cuda``, eager on the CPU): ``xs`` is the
    padded block in the native dtype; under a policy it is cast to
    ``cdt`` and the output cast back.  ``scales`` marks int8 weights,
    dequantized here (``q.to(cdt) * scale``)."""
    if scales is not None:
        weights = tuple(q.to(cdt) * s for q, s in zip(weights, scales))
    if cdt is None:
        return model.run_batch(weights, xs)
    return model.run_batch(weights, xs.to(cdt)).to(xs.dtype)


class _Graph:
    """One captured forward: a static input buffer on the card, the
    CUDA graph of ``fn`` over it, and the graph's static output.
    Calls take the graph's lock around copy-in, replay and copy-out,
    and count the replays."""

    def __init__(self, fn, shape, dtype, device, stream):
        self.device = device
        self.lock = threading.Lock()
        self.replays = 0
        with torch.cuda.device(device), torch.no_grad():
            self.static_in = torch.zeros(shape, dtype=dtype, device=device)
            # warm up on the side stream (cuBLAS's handle and workspace,
            # the allocator's blocks), then capture on it
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                for _ in range(_WARMUP_RUNS):
                    fn(self.static_in)
            torch.cuda.current_stream(device).wait_stream(stream)
            self.graph = torch.cuda.CUDAGraph()
            # no pool argument: the graph's memory is its own
            with _CAPTURE_LOCK, torch.cuda.graph(
                    self.graph, stream=stream,
                    capture_error_mode="thread_local"):
                self.static_out = fn(self.static_in)

    def __call__(self, block: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(block)).to(self.static_in.dtype)
        with self.lock, torch.cuda.device(self.device):
            self.static_in.copy_(x)
            self.graph.replay()
            self.replays += 1
            return self.static_out.cpu().numpy()


class Engine:
    """Pads batches into buckets and runs the captured forwards.

    One engine serves every kernel in ``registry``; forwards are cached
    per ``(name, version, bucket, dtype, precision)`` so a registry
    hot-reload (version bump) or a precision retag transparently
    captures fresh graphs while the old version's age out untouched.
    ``device`` is ``cuda`` unless the caller asks for the CPU;
    ``device_index`` pins a ``cuda`` engine to ``cuda:(i % count)``.
    """

    def __init__(self, registry: Registry, *,
                 max_batch: int = DEFAULT_MAX_BATCH,
                 n_buckets: int = DEFAULT_N_BUCKETS,
                 mode: str | None = None,
                 device_index: int | None = None,
                 device=None):
        if mode is None:
            mode = os.environ.get("HPNN_SERVE_MODE") or None
        if mode is not None and mode not in _MODES:
            raise ValueError(f"unknown serve mode {mode!r} "
                             f"(want {'|'.join(_MODES)})")
        dev = runtime.resolve_device(device)
        if dev.type == "cuda":
            index = dev.index if device_index is None else device_index
            if index is not None:
                dev = torch.device("cuda", int(index) % torch.cuda.device_count())
            # the JAX engine's float32 matmul pin
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.device = dev
        self.registry = registry
        self.max_batch = int(max_batch)
        self.buckets = bucket_menu(max_batch, n_buckets)
        self._mode = mode or ("parity" if dev.type == "cpu" else "compiled")
        # process-default serve precision (read once; per-entry
        # Entry.precision overrides).  None = native full precision.
        default_prec = os.environ.get("HPNN_SERVE_DTYPE") or None
        if default_prec is not None and default_prec not in PRECISIONS:
            raise ValueError(
                f"HPNN_SERVE_DTYPE={default_prec!r} not in "
                f"{'|'.join(PRECISIONS)}")
        self.default_precision = default_prec
        # kernel -> measured max |lowp - f64| on the warmup probe
        # block (the /healthz precision section's error bound)
        self._quant_err: dict[str, float] = {}
        self.device_index = device_index
        # held by captures and every write to the caches; re-entrant: a
        # capture casts the weights, which takes the lock again.  A
        # lookup that hits reads ``_compiled`` without it (a dict read
        # is atomic), so no dispatch waits behind a capture.
        self._lock = threading.RLock()
        self._compiled: dict[tuple, object] = {}
        self._weights_cache: dict[tuple, tuple] = {}
        # (name, version, bucket, dtype, precision) -> hits / misses /
        # compile_s: the cold-start cost surface exposed on /healthz,
        # under its own lock
        self._cache_stats: dict[tuple, dict] = {}
        self._stats_lock = threading.Lock()
        # one side stream (warmup and capture) per engine, made at the
        # first capture
        self._stream = None

    @property
    def mode(self) -> str:
        """"parity" | "compiled"."""
        return self._mode

    # ------------------------------------------------------------ capture
    def _precision(self, entry: Entry) -> str | None:
        """The entry's resolved serve compute policy: per-entry
        override, else the process default, else None (native)."""
        prec = getattr(entry, "precision", None)
        return prec if prec is not None else self.default_precision

    def native_dtype(self, entry: Entry) -> torch.dtype:
        """The dtype a forward takes and returns on this engine: the
        kernel's own on the CPU, ``runtime.compute_dtype`` on ``cuda``."""
        if self.device.type == "cuda":
            return runtime.compute_dtype(self.device)
        return getattr(torch, np.asarray(entry.kernel.weights[0]).dtype.name)

    def _device_weights(self, entry: Entry, prec: str | None = None):
        """Entry weights as tensors on the engine's device, cached per
        (name, version, policy): the cast-ONCE point of the precision
        policy.  bf16/f32/f64 weights are cast from the native dtype,
        int8 weights arrive as ``(int8 tensors, per-layer scales)``."""
        key = (entry.name, entry.version, prec)
        with self._lock:
            w = self._weights_cache.get(key)
            if w is None:
                if prec == "int8":
                    quants, scales = quantize_weights(entry.kernel.weights)
                    w = (tuple(torch.from_numpy(q).to(self.device)
                               for q in quants), tuple(scales))
                else:
                    w, _ = kernel_mod.to_torch(
                        entry.kernel.weights, device=self.device,
                        dtype=self.native_dtype(entry))
                    if prec is not None:
                        w = tuple(a.to(_POLICY_DTYPE[prec]) for a in w)
                self._weights_cache[key] = w
        return w

    def _forward_of(self, body, shape, dtype):
        """The numpy forward of ``body`` over a ``shape`` block in
        ``dtype``: a captured graph on ``cuda``, ``body`` run eagerly on
        the CPU.  The caller holds the engine lock."""
        if self.device.type == "cuda":
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            return _Graph(body, shape, dtype, self.device, self._stream)

        def fn(block):
            with torch.no_grad():
                return body(torch.from_numpy(
                    np.ascontiguousarray(block)).to(dtype)).numpy()
        return fn

    def _cached(self, key):
        """The cached forward under ``key``, counted as a hit, or None.
        Takes no engine lock: a miss takes it, builds, and looks again."""
        fn = self._compiled.get(key)
        if fn is not None:
            with self._stats_lock:
                self._stat(key)["hits"] += 1
            compile_cache.note(True)
        return fn

    def _store(self, key, fn, fill_s, **fields):
        """Cache a new forward and count the miss: one ``serve.compile``
        (the caller holds the engine lock)."""
        obs.count("serve.compile", mode=self.mode, device=str(self.device),
                  **fields)
        compile_cache.note(False)
        self._compiled[key] = fn
        with self._stats_lock:
            stat = self._stat(key)
            stat["misses"] += 1
            stat["compile_s"] += fill_s

    def _compiled_forward(self, entry: Entry, bucket: int, dtype,
                          prec: str | None = None):
        """The cached ``(bucket, n_in) -> (bucket, n_out)`` numpy
        forward for ``entry`` (parity mode: ``(R ≤ bucket, n_in)``, the
        exact rows).  Fills (and counts) the cache at most once per
        (name, version, bucket, dtype, precision)."""
        dtype = np.dtype(dtype)
        if self.mode == "parity":
            prec = None
        key = (entry.name, entry.version, bucket, dtype.str,
               prec or "native")
        fn = self._cached(key)
        if fn is not None:
            return fn
        with self._lock:
            # another thread may have built it while this one waited
            fn = self._cached(key)
            if fn is None:
                fn, fill_s = self._build_forward(entry, bucket, prec)
                self._store(key, fn, fill_s, kernel=entry.name,
                            version=entry.version, bucket=bucket,
                            dtype=dtype.str, precision=prec or "native")
        return fn

    def _build_forward(self, entry: Entry, bucket: int, prec):
        """Build one bucket's forward (the caller holds the lock);
        returns ``(forward, seconds it took)``."""
        model = _model_of(entry)
        native = self.native_dtype(entry)
        dev = self.device
        t_fill = time.perf_counter()
        with obs.timer("serve.compile_time", kernel=entry.name,
                       bucket=bucket):
            if self.mode == "parity":
                w = self._device_weights(entry)
                run = model.run

                def fn(xs, _w=w, _run=run):
                    with torch.no_grad():
                        return np.stack([
                            _run(_w, torch.tensor(x, dtype=native,
                                                  device=dev)).cpu().numpy()
                            for x in xs])
            else:
                weights = self._device_weights(entry, prec)
                cdt = _POLICY_DTYPE.get(prec)
                scales = None
                if prec == "int8":
                    weights, scales = weights
                if cdt is torch.bfloat16 and dev.type == "cuda":
                    # the f32-accumulation pin of bf16 products
                    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

                def body(xs, _w=weights, _s=scales, _c=cdt, _m=model):
                    return batch_forward(_m, _w, xs, _c, _s)

                fn = self._forward_of(body, (bucket, entry.n_inputs), native)
        return fn, time.perf_counter() - t_fill

    @staticmethod
    def _exe_name(key: tuple) -> str:
        name, version, bucket, _dtype, prec = key
        base = f"serve.{name}.v{version}.b{bucket}"
        return base if prec == "native" else f"{base}.{prec}"

    def _stat(self, key: tuple) -> dict:
        # callers hold self._stats_lock
        stat = self._cache_stats.get(key)
        if stat is None:
            stat = self._cache_stats[key] = {
                "hits": 0, "misses": 0, "compile_s": 0.0}
        return stat

    def cache_stats(self) -> dict[str, dict]:
        """Per-(kernel, version, bucket) forward-cache census for
        ``/healthz``: hits, misses, cumulative capture seconds.  After
        warmup every entry should show ``misses == 1`` and a growing
        hit count — a second miss is a cold-start regression."""
        def label(k):
            if len(k) == 5 and k[4] != "native":
                return f"{k[0]}/v{k[1]}/b{k[2]}/{k[4]}"
            return f"{k[0]}/v{k[1]}/b{k[2]}"

        with self._stats_lock:
            return {
                label(k): {
                    "hits": s["hits"], "misses": s["misses"],
                    "compile_s": round(s["compile_s"], 6)}
                for k, s in sorted(self._cache_stats.items(),
                                   key=lambda kv: str(kv[0]))}

    def _probe_quant_err(self, entry: Entry, fn, bucket: int,
                         dtype, prec: str) -> float:
        """Measure the policy's error on a deterministic probe block:
        ``max |policy output − CPU float64 per-row reference|``.
        Published as the ``numerics.quant_err`` gauge and the /healthz
        precision section."""
        model = _model_of(entry)
        rng = np.random.RandomState(0xC0FFEE)
        xs = rng.randn(bucket, entry.n_inputs).astype(dtype)
        low = np.asarray(fn(xs), dtype=np.float64)
        w64, _ = kernel_mod.to_torch(entry.kernel.weights, device="cpu",
                                     dtype=torch.float64)
        with torch.no_grad():
            ref = np.stack([model.run(w64, torch.tensor(x)).numpy()
                            for x in xs.astype(np.float64)])
        err = float(np.max(np.abs(low - ref)))
        self._quant_err[entry.name] = err
        obs.gauge("numerics.quant_err", err, where="serve",
                  kernel=entry.name, precision=prec, bucket=bucket)
        return err

    def precision_doc(self, names=None) -> dict:
        """The /healthz ``precision`` section: the process default,
        engine mode, and per-kernel resolved policy + measured
        ``quant_err`` (present once warmup probed the kernel)."""
        kernels = {}
        for name in (self.registry.names() if names is None
                     else names):
            try:
                entry = self.registry.get(name)
            except KeyError:
                continue  # unregistered between listing and scan
            prec = self._precision(entry)
            doc = {"precision": prec or "native",
                   "version": entry.version}
            err = self._quant_err.get(name)
            if err is not None:
                doc["quant_err"] = err
            kernels[name] = doc
        return {"default": self.default_precision or "native",
                "mode": self.mode, "kernels": kernels}

    def warmup(self, names=None, *, dtype=None) -> int:
        """Capture the full bucket menu for ``names`` (default: every
        registered kernel).  Returns the number of forwards built.
        Steady-state serving after warmup never captures — the obs
        ``serve.compile`` total stays at
        ``len(names) * len(self.buckets)``.  Quantized kernels get a
        ``serve.precision`` event and a measured ``numerics.quant_err``
        probe (compiled mode)."""
        names = self.registry.names() if names is None else list(names)
        n = 0
        for name in names:
            entry = self.registry.get(name)
            dt = dtype or np.asarray(entry.kernel.weights[0]).dtype
            prec = self._precision(entry)
            for bucket in self.buckets:
                fn = self._compiled_forward(entry, bucket, dt,
                                            prec=prec)
                n += 1
            if prec is not None and self.mode == "compiled":
                obs.event("serve.precision", kernel=name,
                          precision=prec, version=entry.version,
                          source="warmup")
                # fn is the top-bucket forward from the loop above
                self._probe_quant_err(entry, fn, self.buckets[-1],
                                      dt, prec)
        obs.event("serve.warmup", kernels=len(names),
                  buckets=len(self.buckets))
        return n

    # ------------------------------------------------------------ run
    def _dispatch_work(self, entry: Entry, prec, bucket: int):
        """(bytes, flops, dtype) of one bucket's forward (HPNN_COST)."""
        cdt = _POLICY_DTYPE.get(prec) or self.native_dtype(entry)
        wbytes = 1 if prec == "int8" else cdt.itemsize
        shapes = [tuple(np.asarray(w).shape) for w in entry.kernel.weights]
        nbytes, flops = obs.cost.forward_work(
            shapes, bucket, wbytes, self.native_dtype(entry).itemsize)
        return nbytes, flops, cdt

    def run_rows(self, entry: Entry, rows: np.ndarray) -> np.ndarray:
        """Forward ``rows`` (R, n_in) → (R, n_out) through the bucket
        menu: quantize to the smallest fitting bucket, or chunk through
        the largest one when R exceeds it.  compiled mode pads the
        block up to the bucket's fixed shape; parity mode hands the
        exact rows to the per-row closure."""
        rows = np.asarray(rows)
        if rows.ndim != 2 or rows.shape[1] != entry.n_inputs:
            raise ValueError(
                f"rows must be (R, {entry.n_inputs}); got {rows.shape}")
        dtype = np.asarray(entry.kernel.weights[0]).dtype
        prec = self._precision(entry)
        prec_tag = (prec or "native") if self.mode != "parity" \
            else "native"
        fns: dict[int, tuple] = {}
        rows = rows.astype(dtype, copy=False)
        out = np.empty((rows.shape[0], entry.n_outputs), dtype=dtype)
        # one read of the menu: the tuning plane swaps it whole
        # (grow_buckets) while batchers dispatch
        menu = self.buckets
        top = menu[-1]
        start = 0
        while start < rows.shape[0]:
            n = min(rows.shape[0] - start, top)
            bucket = bucket_for(menu, n)
            obs.count("serve.bucket_hit", kernel=entry.name,
                      bucket=bucket, rows=n)
            # pad-waste: fraction of the bucket's rows that are zero
            # padding (compiled mode pads; parity runs exact rows)
            obs.gauge("serve.pad_waste",
                      0.0 if self.mode == "parity"
                      else (bucket - n) / bucket,
                      kernel=entry.name, bucket=bucket, rows=n)
            cached = fns.get(bucket)
            if cached is None:
                cached = fns[bucket] = (
                    self._compiled_forward(entry, bucket, dtype,
                                           prec=prec),
                    self._exe_name((entry.name, entry.version, bucket,
                                    dtype.str, prec_tag)))
            fn, exe_name = cached
            if self.mode == "compiled" and n < bucket:
                block = np.zeros((bucket, entry.n_inputs), dtype=dtype)
                block[:n] = rows[start:start + n]
            else:
                block = rows[start:start + n]
            if obs.cost.enabled() or obs.meter.enabled():
                # a dispatch ends in the output's copy to the host, so
                # the host clock around it holds the whole device work
                t0 = time.perf_counter()
                res = fn(block)
                dt = time.perf_counter() - t0
                if obs.cost.enabled():
                    nbytes, flops, cdt = self._dispatch_work(
                        entry, None if self.mode == "parity" else prec,
                        bucket)
                    obs.cost.record_dispatch(
                        exe_name, dt, nbytes=nbytes, flops=flops,
                        dtype=cdt, device=self.device, units=bucket,
                        kernel=entry.name, bucket=bucket, mode=self.mode)
                # padding does the full bucket's work, so the cataloged
                # (per-bucket) cost applies unscaled to the owning
                # tenant's meter
                obs.meter.note_dispatch(entry.name, dt, exe=exe_name)
            else:
                res = fn(block)
            out[start:start + n] = res[:n]
            start += n
        return out

    def eager_rows(self, entry: Entry, rows: np.ndarray) -> np.ndarray:
        """``rows`` (R ≤ top bucket) through the compiled-mode batched
        forward run eagerly — no graph — on the same padded bucket block
        and the same cached weights: what a replay must reproduce."""
        rows = np.asarray(rows)
        bucket = bucket_for(self.buckets, rows.shape[0])
        native = self.native_dtype(entry)
        prec = self._precision(entry)
        weights = self._device_weights(entry, prec)
        scales = None
        if prec == "int8":
            weights, scales = weights
        block = np.zeros((bucket, entry.n_inputs), dtype=rows.dtype)
        block[:rows.shape[0]] = rows
        with torch.no_grad():
            x = torch.from_numpy(block).to(device=self.device, dtype=native)
            out = batch_forward(_model_of(entry), weights, x,
                                _POLICY_DTYPE.get(prec), scales)
            return out.cpu().numpy()[:rows.shape[0]]

    def dispatch(self, entry_name: str, payloads) -> list[np.ndarray]:
        """Batcher dispatch hook: concatenate the payload row blocks,
        run them through one (or a few) bucket dispatches, split the
        results back per payload."""
        chaos.inject("serve.dispatch")  # seam: device dispatch
        entry = self.registry.get(entry_name)
        blocks = [np.atleast_2d(np.asarray(p)) for p in payloads]
        for b in blocks:
            if b.shape[1] != entry.n_inputs:
                raise ValueError(
                    f"payload width {b.shape[1]} != kernel n_inputs "
                    f"{entry.n_inputs}")
        counts = [b.shape[0] for b in blocks]
        with obs.timer("serve.forward", kernel=entry_name,
                       rows=sum(counts)):
            out = self.run_rows(entry, np.concatenate(blocks, axis=0))
        if obs.probes.enabled():
            # serve-side NaN tripwire: census the outputs (already host
            # numpy) into the per-kernel /healthz numerics verdict
            obs.probes.note_serve(entry_name, rows=int(out.shape[0]),
                                  nan=int(np.isnan(out).sum()))
        if obs.drift.enabled():
            # prediction-drift tap (obs/drift.py): the host numpy the
            # copy-out already made — no graph is touched, no sync added
            obs.drift.note_pred(entry_name, out)
        results = []
        start = 0
        for c in counts:
            results.append(out[start:start + c])
            start += c
        return results

    # ------------------------------------------------------------ fleet
    def _fleet_forward(self, entries: tuple, bucket: int, dtype):
        """The cached fleet forward for a same-topology member set: one
        forward answering all N members' padded blocks at once.

        compiled mode: the members' weights are stacked as ``(N, n, m)``
        and the model's ``run_batch`` (one batched matmul a layer) runs
        the ``(N, bucket, n_in) -> (N, bucket, n_out)`` block, captured
        as one graph per member set and bucket on ``cuda``.  parity mode: a closure running each
        member's EXACT rows through that member's per-kernel parity
        closure (:meth:`_compiled_forward`), so fleet answers are
        bitwise equal to per-kernel ``dispatch``."""
        dtype = np.dtype(dtype)
        key = (("fleet",)
               + tuple((e.name, e.version) for e in entries),
               bucket, dtype.str)
        fn = self._cached(key)
        if fn is not None:
            return fn
        with self._lock:
            fn = self._cached(key)
            if fn is not None:
                return fn
            first = entries[0]
            model = _model_of(first)
            native = self.native_dtype(first)
            t_fill = time.perf_counter()
            with obs.timer("serve.compile_time", kernel="(fleet)",
                           bucket=bucket, members=len(entries)):
                if self.mode == "parity":
                    members = [self._compiled_forward(e, bucket, dtype)
                               for e in entries]

                    def fn(blocks, _members=members):
                        return [np.asarray(m(b))
                                for m, b in zip(_members, blocks)]
                else:
                    per = [self._device_weights(e) for e in entries]
                    stacked = tuple(torch.stack([w[l] for w in per])
                                    for l in range(len(per[0])))

                    def body(xs, _w=stacked, _m=model):
                        return _m.run_batch(_w, xs)

                    fn = self._forward_of(
                        body, (len(entries), bucket, first.n_inputs), native)
            self._store(key, fn, time.perf_counter() - t_fill,
                        kernel="(fleet)", members=len(entries),
                        bucket=bucket, dtype=dtype.str)
        return fn

    @staticmethod
    def _fleet_exe_name(key: tuple) -> str:
        members, bucket, dtype_str = key
        sig = hashlib.md5(repr(members[1:]).encode()).hexdigest()[:8]
        return f"serve.fleet.n{len(members) - 1}.b{bucket}.{sig}"

    def dispatch_fleet(self, payloads) -> list[np.ndarray]:
        """Fleet batcher dispatch hook: ``payloads`` is a list of
        ``(kernel_name, rows)`` pairs from MANY kernels.  Names are
        grouped by :func:`fleet_key`; every group with ≥ 2 distinct
        same-topology kernels is answered by ONE coalesced fleet
        forward (each member padded to the group's common bucket),
        and singleton groups fall back to the per-kernel
        :meth:`dispatch` path.  Returns one result per payload, in
        payload order."""
        named = []
        for name, rows in payloads:
            named.append((name, np.atleast_2d(np.asarray(rows))))
        groups: dict[tuple, list[int]] = {}
        entries = {}
        for i, (name, _rows) in enumerate(named):
            if name not in entries:
                entries[name] = self.registry.get(name)
            groups.setdefault(fleet_key(entries[name]), []).append(i)
        results: list = [None] * len(named)
        menu = self.buckets
        top = menu[-1]
        for idxs in groups.values():
            # member order: first appearance of each kernel name
            by_name: dict[str, list[int]] = {}
            for i in idxs:
                by_name.setdefault(named[i][0], []).append(i)
            rows_for = {
                name: np.concatenate([named[i][1] for i in ixs])
                for name, ixs in by_name.items()}
            max_rows = max(r.shape[0] for r in rows_for.values())
            if len(by_name) < 2 or max_rows > top:
                # singleton topology — or a member too big for the
                # bucket menu (the per-kernel path chunks, the fixed
                # (N, bucket) fleet block cannot): per-kernel dispatch
                for name, ixs in by_name.items():
                    outs = self.dispatch(
                        name, [named[i][1] for i in ixs])
                    for i, out in zip(ixs, outs):
                        results[i] = out
                continue
            members = sorted(by_name)  # stable member order
            ents = tuple(entries[m] for m in members)
            bucket = bucket_for(menu, max_rows)
            n = len(members)
            dtype = np.asarray(
                ents[0].kernel.weights[0]).dtype
            obs.gauge("fleet.size", n, where="serve")
            obs.count("serve.fleet_group", members=n, bucket=bucket,
                      rows=int(sum(r.shape[0]
                                   for r in rows_for.values())))
            fn = self._fleet_forward(ents, bucket, dtype)
            with obs.spans.span("serve.fleet_dispatch", members=n,
                                bucket=bucket):
                if self.mode == "parity":
                    blocks = [rows_for[m].astype(dtype, copy=False)
                              for m in members]
                    if obs.meter.enabled():
                        t0 = time.perf_counter()
                        outs = fn(blocks)
                        dt = time.perf_counter() - t0
                        # parity blocks are unpadded, so each member's
                        # true row count is known: split wall time
                        # row-proportionally (the padded path below
                        # splits evenly — every member costs a full
                        # bucket there)
                        total = sum(b.shape[0] for b in blocks) or 1
                        for m, b in zip(members, blocks):
                            obs.meter.note_dispatch(
                                m, dt * b.shape[0] / total,
                                rows=b.shape[0])
                    else:
                        outs = fn(blocks)
                else:
                    stackb = np.zeros(
                        (n, bucket, ents[0].n_inputs), dtype=dtype)
                    for j, m in enumerate(members):
                        r = rows_for[m]
                        stackb[j, :r.shape[0]] = r
                    if obs.cost.enabled() or obs.meter.enabled():
                        t0 = time.perf_counter()
                        res = fn(stackb)
                        dt = time.perf_counter() - t0
                        exe = self._fleet_exe_name(
                            (("fleet",)
                             + tuple((e.name, e.version)
                                     for e in ents),
                             bucket, dtype.str))
                        if obs.cost.enabled():
                            nbytes, flops, cdt = self._dispatch_work(
                                ents[0], None, bucket)
                            obs.cost.record_dispatch(
                                exe, dt, nbytes=n * nbytes,
                                flops=n * flops, dtype=cdt,
                                device=self.device, units=n * bucket,
                                members=n, bucket=bucket, mode=self.mode)
                        # one graph ran every member's bucket: split
                        # wall time evenly, scale the cataloged
                        # (n*bucket-unit) cost to each member's bucket
                        for m in members:
                            obs.meter.note_dispatch(m, dt / n,
                                                    rows=bucket, exe=exe)
                    else:
                        res = fn(stackb)
                    outs = [res[j, :rows_for[m].shape[0]]
                            for j, m in enumerate(members)]
            for m, out in zip(members, outs):
                got = rows_for[m].shape[0]
                obs.gauge("serve.pad_waste",
                          0.0 if self.mode == "parity"
                          else (bucket - got) / bucket,
                          kernel=m, bucket=bucket, rows=got,
                          fleet=True)
                if obs.probes.enabled():
                    obs.probes.note_serve(
                        m, rows=got, nan=int(np.isnan(out).sum()))
                if obs.drift.enabled():
                    obs.drift.note_pred(m, out)
                start = 0
                for i in by_name[m]:
                    c = named[i][1].shape[0]
                    results[i] = out[start:start + c].astype(dtype, copy=False)
                    start += c
        return results

    # ------------------------------------------------------------ misc
    def compiled_count(self) -> int:
        return len(self._compiled)

    def replay_count(self) -> int:
        """Graph replays of the forwards now cached (0 off ``cuda``)."""
        # list() copies the values in one step, as a capture may add one
        return sum(getattr(fn, "replays", 0)
                   for fn in list(self._compiled.values()))

    def upload(self, name: str) -> float:
        """Put ``name``'s weights on the engine's device in its resolved
        policy (the cast-once cache the captures read), waiting for the
        copy: the host-to-device part of a tenant page-in, timed apart
        from its captures.  Returns the seconds it took."""
        entry = self.registry.get(name)
        t0 = time.perf_counter()
        self._device_weights(
            entry, None if self.mode == "parity" else self._precision(entry))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def evict(self, name: str, *, keep_version: int | None = None):
        """Drop cached forwards/weights for ``name`` (all versions, or
        all but ``keep_version``): reload housekeeping, and the tenant
        pager's page-out (tenant/pager.py).  These caches hold the only
        references to a kernel's graphs, static buffers and device
        weights, so a dropped graph's static buffers and its weights
        return their memory (its private pool goes back to the card at
        the next capture, which empties the allocator's cache); fleet
        forwards whose member set includes
        ``name`` go too, since a stacked forward holds every member's
        weights.  A batch that already holds a forward finishes on it
        (Python keeps it alive until then)."""
        def _fleet_member(k: tuple) -> bool:
            head = k[0]
            if not (isinstance(head, tuple) and head
                    and head[0] == "fleet"):
                return False
            return any(m == name and v != keep_version
                       for m, v in head[1:])

        with self._lock:
            for key in [k for k in self._compiled
                        if (k[0] == name and k[1] != keep_version)
                        or _fleet_member(k)]:
                del self._compiled[key]
            for key in [k for k in self._weights_cache
                        if k[0] == name and k[1] != keep_version]:
                del self._weights_cache[key]
