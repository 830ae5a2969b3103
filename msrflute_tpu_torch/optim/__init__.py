from .factory import (SGD, Adam, Adamax, AdamW, Lamb, Lars,  # noqa: F401
                      Yogi, make_optimizer)
from .fused import (combine_grad_terms, fused_apply,  # noqa: F401
                    fused_opt_apply, segment_norms, trust_ratio)
from .schedulers import PlateauTracker, make_lr_schedule  # noqa: F401
