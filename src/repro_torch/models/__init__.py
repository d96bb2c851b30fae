"""The LM stack of the port: layers, attention on the port's two
attention kernels, the MoE FFN, the decoder model of the serve path, and
conversion from the reference's parameter tree."""
from . import attention, convert, layers, model, moe  # noqa: F401
from .convert import params_from_numpy, params_to_numpy  # noqa: F401
from .model import (Model, decode_step, forward_hidden,  # noqa: F401
                    forward_logits, init_cache, init_params, prefill)
