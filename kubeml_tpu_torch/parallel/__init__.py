"""Training engines of the port: ``SPMDTrainer`` on one card with its LM
losses. Sharding over ``torch.distributed`` is not ported yet."""

from .trainer import SPMDTrainer, adamw, chunked_lm_loss, lm_loss

__all__ = ["SPMDTrainer", "adamw", "chunked_lm_loss", "lm_loss"]
