from mcjax_torch.core.config import SimConfig
from mcjax_torch.core.state import SimState, init_state, zeros_state

__all__ = ["SimConfig", "SimState", "init_state", "zeros_state"]
