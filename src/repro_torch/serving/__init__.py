from repro_torch.serving.chaos import FaultInjector, InjectedFault  # noqa: F401
from repro_torch.serving.engine import ServingEngine  # noqa: F401
from repro_torch.serving.invariants import assert_pool_invariants  # noqa: F401
from repro_torch.serving.scheduler import (  # noqa: F401
    VICTIM_POLICIES,
    ContinuousScheduler,
    Request,
)
