"""The port's runtime layer: named faults and injection sites
(:mod:`.faults`), the control-plane stores (:mod:`.store`),
supervision, health and the request journal (:mod:`.heal`), and
observability: the event bus and flight recorder (:mod:`.scope`), the
device-memory ledger (:mod:`.hbm`), the ownership ledger (:mod:`.life`)
and cross-rank collection and goodput (:mod:`.fleet`)."""

from .faults import (FaultInjected, FaultPlan, FaultRule,  # noqa: F401
                     FaultTimeout, GraftFaultError, PeerLostError,
                     maybe_fault, plan_from_spec, register_site)
from .store import MemStore, TCPStore, TCPStoreServer  # noqa: F401
