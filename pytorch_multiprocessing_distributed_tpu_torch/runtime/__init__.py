"""The port's runtime fault layer: named faults and injection sites
(:mod:`.faults`), the control-plane stores (:mod:`.store`) and the
training half of supervision (:mod:`.heal`)."""

from .faults import (FaultInjected, FaultPlan, FaultRule,  # noqa: F401
                     FaultTimeout, GraftFaultError, PeerLostError,
                     maybe_fault, plan_from_spec, register_site)
from .store import MemStore, TCPStore, TCPStoreServer  # noqa: F401
