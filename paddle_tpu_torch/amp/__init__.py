"""Mixed precision of the fluid path: the op lists (`fp16_lists`, copied
from the JAX package) that `core/precision.autocast_op_inputs` reads.
The rest of the JAX package's `amp/` (the decorator) is not ported."""
