"""The port's train and serve step factories (`repro/train/`)."""
from .step import (load_state_tree, make_prefill_step,  # noqa: F401
                   make_serve_step, make_train_state, make_train_step,
                   state_tree, step_traffic)
