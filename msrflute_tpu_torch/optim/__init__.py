from .factory import SGD, Adam, Adamax, AdamW, make_optimizer  # noqa: F401
from .fused import (combine_grad_terms, fused_apply,  # noqa: F401
                    fused_opt_apply)
from .schedulers import PlateauTracker, make_lr_schedule  # noqa: F401
