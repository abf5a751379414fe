"""``TenantSession``: the multi-tenant serving host.

A copy of ``hpnn_tpu/tenant/host.py`` with its imports re-pointed at
``hpnn_tpu_torch``.

Composes the tenant subsystem over the single-tenant ``serve.Session``
(docs/serving.md): the registry becomes a lock-striped
:class:`~hpnn_tpu_torch.tenant.shards.ShardedRegistry`, a
:class:`~hpnn_tpu_torch.tenant.pager.Pager` bounds the resident set, and a
:class:`~hpnn_tpu_torch.tenant.quota.QuotaEnforcer` charges every request
against its tenant's rate/concurrency budget before it touches a
batcher queue.  Kernel names are **tenant-scoped** —
``<tenant>:<kernel>`` — so namespaces never collide; the HTTP edge
(serve/server.py) routes ``X-Tenant`` headers here via
:meth:`infer_for` and keeps bare ``Session`` semantics for hosts
without tenancy.

Cross-tenant fleet grouping comes free: with ``fleet=True`` every
scoped kernel rides the one shared batcher and
``engine.dispatch_fleet`` groups members by *topology*
(``fleet_key`` carries model/shapes/dtype, never the name), so 10k
tiny nets from different tenants coalesce into stacked executables
instead of each paying the dispatch floor (docs/fleet.md).

The request path per infer: quota admit (reject = ``shed
reason=quota``, 429 with the tenant named in the body) → pager pin
(pages a cold kernel in, blocks an in-flight page-out race) →
``Session.infer`` → per-tenant SLO window record → release.
"""

from __future__ import annotations

from hpnn_tpu_torch import obs, tune
from hpnn_tpu_torch.serve.server import Session
from hpnn_tpu_torch.tenant.pager import Pager
from hpnn_tpu_torch.tenant.quota import QuotaEnforcer, TenantSpec
from hpnn_tpu_torch.tenant.shards import ShardedRegistry

DEFAULT_TENANT = "default"


def scoped(tenant: str, kernel: str) -> str:
    return f"{tenant}:{kernel}"


class TenantSession(Session):
    """One serving process hosting many tenants' kernels.

    ``shards``/``resident_max``/``page_dir``/``tenants`` default to
    their knobs (``HPNN_TENANT_SHARDS`` / ``HPNN_TENANT_RESIDENT`` /
    ``HPNN_TENANT_PAGE_DIR`` / ``HPNN_TENANTS``); ``page_warmup``
    captures the bucket menu on page-in so the measured cold-hit
    latency covers the full back-to-servable cost (``cuda`` refuses it
    off: tenant/pager.py says why).  Everything else
    is the ``Session`` surface unchanged — ``device`` included: the
    host runs on ``cuda`` unless the caller passes ``device="cpu"``.
    Under ``HPNN_TUNE`` the session's tuner is rebuilt over the quota
    enforcer too, so its ``quota_squeeze`` actuator has the declared
    rate caps to squeeze."""

    def __init__(self, *, shards: int | None = None,
                 resident_max: int | None = None,
                 page_dir: str | None = None,
                 tenants: dict[str, TenantSpec] | None = None,
                 page_warmup: bool = True, **kw):
        super().__init__(**kw)
        # re-point the session at the striped registry; the engine
        # holds the registry by reference, so one swap re-bases its
        # lookups too (its compiled/weights caches are still empty
        # here — nothing to migrate)
        self.registry = ShardedRegistry(shards)
        self.engine.registry = self.registry
        self.quota = QuotaEnforcer(tenants, clock=self._clock)
        self.pager = Pager(self.registry, self.engine,
                           resident_max=resident_max,
                           page_dir=page_dir, warmup=page_warmup,
                           clock=self._clock)
        if self.pager.page_dir:
            # warm boot: adopt whatever a previous worker (this host
            # or any other sharing the store) paged out
            self.pager.preload_index()
        if self.tuner is not None:
            # Session.__init__ built the tuner before the quota existed
            self.tuner.stop()
            self.tuner = tune.for_session(self)
            if self._start:
                self.tuner.start()

    # ------------------------------------------------------------ kernels
    # A registration runs in ``pager.adopting`` (the port's pager pages
    # in outside its lock, and a page-in of the same name must not land
    # over the new weights); a promotion or reload tracks the name while
    # its pin still holds it resident.
    def register_kernel(self, name, kernel, **kw):
        with self.pager.adopting(name):
            return super().register_kernel(name, kernel, **kw)

    def load_kernel(self, name, path, **kw):
        with self.pager.adopting(name):
            return super().load_kernel(name, path, **kw)

    def register_for(self, tenant: str, kernel_name: str, kernel,
                     **kw):
        """Register ``kernel_name`` under ``tenant``'s scope."""
        return self.register_kernel(scoped(tenant, kernel_name),
                                    kernel, **kw)

    def install_kernel(self, name, kernel, **kw):
        # a promotion landing on a paged-out kernel pages it in first
        # (the install needs the prior entry for model/path carryover
        # and the version bump must chain off the real lineage)
        with self.pager.pin(name):
            entry = super().install_kernel(name, kernel, **kw)
            self.pager.track(name)
        return entry

    def reload(self, name, **kw):
        with self.pager.pin(name):
            entry = super().reload(name, **kw)
            self.pager.track(name)
        return entry

    # ------------------------------------------------------------ infer
    def infer(self, name, x, **kw):
        """Session-surface infer over a possibly-paged kernel: pin
        (page in when cold) for the duration.  No quota — callers
        that bypass :meth:`infer_for` are the host process itself."""
        with self.pager.pin(name):
            return super().infer(name, x, **kw)

    def infer_for(self, tenant: str | None, kernel_name: str, x,
                  **kw):
        """The tenant-scoped request path: quota admission, paging
        pin, per-tenant SLO accounting.  Raises
        :class:`~hpnn_tpu_torch.tenant.quota.QuotaExceeded` (a ``Shed``
        with ``reason="quota"``) over budget; ``KeyError`` for a
        kernel the tenant never registered."""
        tenant = tenant or DEFAULT_TENANT
        name = scoped(tenant, kernel_name)
        self.quota.admit(tenant, kernel=kernel_name)
        t0 = self._clock()
        try:
            with self.pager.pin(name):
                out = super().infer(name, x, **kw)
        finally:
            self.quota.release(tenant)
        self.quota.record(tenant, self._clock() - t0)
        shape = getattr(x, "shape", None)
        obs.meter.note_request(
            tenant, shape[0] if shape and len(shape) == 2 else 1)
        return out

    # ------------------------------------------------------------ health
    def tenant_doc(self) -> dict:
        """The ``GET /tenantz`` document: per-tenant quota/SLO census,
        pager state, registry shard balance."""
        return {"tenants": self.quota.health_doc(),
                "pager": self.pager.health_doc(),
                "registry": self.registry.census()}

    def health(self) -> dict:
        doc = super().health()
        doc["tenancy"] = self.tenant_doc()
        return doc

    # ------------------------------------------------------------ close
    def close(self):
        super().close()
        obs.event("tenant.close",
                  resident=self.pager.health_doc()["resident"])
