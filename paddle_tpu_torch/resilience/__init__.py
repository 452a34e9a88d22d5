"""Fault tolerance for long training runs: the JAX package's
`resilience/` package, for the port.

- atomic.py             crash-safe file writes (tmp + os.replace)
                        (copied)
- checkpoint_manager.py CheckpointManager: commit markers, retention,
                        retry with backoff, corrupt-fallback restore
                        (copied; its default payload is
                        parallel/checkpoint.py's torch TrainState)
- preemption.py         SIGTERM → stop-at-step-boundary → final
                        checkpoint → PREEMPT_EXIT_CODE (copied)
- policy.py             RecoveryPolicy/RecoveryController: skip-batch /
                        rollback-with-LR-backoff / abort on health
                        anomalies (torch optimizers' param groups)
- faults.py             PADDLE_TPU_FAULT_SPEC deterministic fault
                        injection (copied)
- retry.py              retry_io and CircuitBreaker (copied)

Training-loop integration lives in parallel/train.py (`train_loop`).
Not ported: the launcher's restart budgets (distributed/launch.py) and
elastic resizing (ROADMAP item 20e).
"""

from . import atomic  # noqa: F401
from . import faults  # noqa: F401
from . import preemption  # noqa: F401
from . import retry  # noqa: F401
from .checkpoint_manager import (  # noqa: F401
    COMMIT_MARKER, CheckpointError, CheckpointManager,
)
from .faults import CRASH_EXIT_CODE, FaultInjected, InjectedIOError  # noqa: F401
from .policy import (  # noqa: F401
    RecoveryAbort, RecoveryController, RecoveryPolicy,
    scale_learning_rate,
)
from .preemption import PREEMPT_EXIT_CODE  # noqa: F401
from .retry import retry_io  # noqa: F401
