"""Model zoo of the port: the reference's src/repro/models as
nn.Modules, with the loss that training differentiates."""
from .lm import LM, forward_hidden, init_lm, lm_logits_last, lm_loss, with_parameters

__all__ = ["LM", "forward_hidden", "init_lm", "lm_logits_last", "lm_loss",
           "with_parameters"]
