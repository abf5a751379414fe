"""Multi-tenant hosting subsystem (docs/tenancy.md).

A copy of ``hpnn_tpu/tenant/__init__.py`` with its imports re-pointed at
``hpnn_tpu_torch``.

Turns the single-tenant serving stack into one process hosting
thousands of kernels for many tenants with bounded memory and
per-tenant fairness:

* :mod:`~hpnn_tpu_torch.tenant.shards` — lock-striped registry sharding
  (``HPNN_TENANT_SHARDS``);
* :mod:`~hpnn_tpu_torch.tenant.pager` — cold-kernel paging LRU over a
  content-addressed checkpoint store (``HPNN_TENANT_RESIDENT`` /
  ``HPNN_TENANT_PAGE_DIR``) plus persistent-compile-cache GC;
* :mod:`~hpnn_tpu_torch.tenant.quota` — per-tenant SLO classes and
  rate/concurrency quotas (``HPNN_TENANTS``), enforced at admission
  as ``shed reason=quota``;
* :mod:`~hpnn_tpu_torch.tenant.host` — :class:`TenantSession`, the
  composed serving host the HTTP edge binds.

jax-free at import, like the rest of ``hpnn_tpu_torch.serve``.
"""

from hpnn_tpu_torch.tenant.host import DEFAULT_TENANT, TenantSession, scoped
from hpnn_tpu_torch.tenant.pager import Pager, PagingError
from hpnn_tpu_torch.tenant.quota import (SLO_CLASSES, QuotaEnforcer,
                                   QuotaExceeded, TenantSpec,
                                   parse_tenants)
from hpnn_tpu_torch.tenant.shards import ShardedRegistry, shard_of

__all__ = [
    "DEFAULT_TENANT", "TenantSession", "scoped",
    "Pager", "PagingError",
    "SLO_CLASSES", "QuotaEnforcer", "QuotaExceeded", "TenantSpec",
    "parse_tenants",
    "ShardedRegistry", "shard_of",
]
