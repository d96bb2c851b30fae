"""The LM stack of the port: layers, attention on the port's two
attention kernels, the MoE FFN, the SSM and xLSTM scans, the decoder
model of the serve and train paths, its sharding rules and placement on
a mesh, and conversion from the reference's parameter tree and train
state."""
from . import (attention, convert, layers, model, moe,  # noqa: F401
               partition, sharding, ssm)
from .convert import (params_from_numpy, params_to_numpy,  # noqa: F401
                      train_state_from_numpy, train_state_to_numpy)
from .model import (CacheBlocks, Model, decode_step,  # noqa: F401
                    forward_hidden, forward_logits, init_cache, init_params,
                    prefill, shard_model, train_loss)
