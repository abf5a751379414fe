"""hpnn_tpu_torch.tune — the audited self-tuning remediation plane.

A copy of ``hpnn_tpu/tune/__init__.py`` with its imports re-pointed at
``hpnn_tpu_torch``.

The observability stack ends at a verdict: the online blame engine
(obs/blame.py) says *where* the tail time goes, the SLO tracker
(obs/slo.py) says *whether* it hurts.  This package closes the loop —
a policy engine (:mod:`hpnn_tpu_torch.tune.engine`) maps each dominant
blame class to the one serving knob that relieves it:

=============  =====================================================
blame class    remediation
=============  =====================================================
queue          ``scale_up`` — grow the fleet one policy step
               (fleet/autoscaler.py ``request_up``)
dispatch       ``precision_down`` — downshift the hottest kernel's
               serve precision one notch, gated by the measured
               quant-error probe (serve/registry.py
               ``set_precision`` + engine ``numerics.quant_err``)
spill          ``grow_buckets`` — add a finer bucket to the engine's
               shape menu (serve/engine.py ``bucket_menu``)
shed_retry     ``quota_squeeze`` — halve declared tenant rate caps
               so overload is rejected at admission, not after
               queueing (tenant/quota.py ``squeeze``)
=============  =====================================================

Every action is a typed, audited ``tune.apply`` event; every decision
(including the ticks that did nothing, and why) lands in a bounded
ledger and — throttled — as ``tune.decision`` events; every applied
action arms a bounded watch window that rolls the change back
(``tune.rollback``, prior config restored bitwise) on a p99
regression, the same post-change regression-watch shape the online
promotion gate uses (online/promote.py).  ``/tunez`` serves the live
census; ``tools/check_obs_catalog.py --tune`` lints the event schema;
``tools/chaos_drill.py --drill tune`` proves one apply-and-recover
(and one deliberate bad move that rolls back) per blame class.

Armed by ``HPNN_TUNE`` (policy knobs ``HPNN_TUNE_*``;
docs/selftuning.md).  Unarmed, the plane costs one env read.
"""

from hpnn_tpu_torch.tune.engine import (
    ACTIONS,
    ENV_KNOB,
    RULE_OF,
    Policy,
    Tuner,
    Veto,
    configure,
    decide,
    enabled,
    for_session,
    health_doc,
    tunez_doc,
    _reset_for_tests,
)

__all__ = [
    "ACTIONS",
    "ENV_KNOB",
    "RULE_OF",
    "Policy",
    "Tuner",
    "Veto",
    "configure",
    "decide",
    "enabled",
    "for_session",
    "health_doc",
    "tunez_doc",
]
