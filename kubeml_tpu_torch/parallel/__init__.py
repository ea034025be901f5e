"""Training engines of the port: ``SPMDTrainer`` on one card with its LM
losses; ``mesh`` (one-device meshes) and ``moe`` (the MoE blocks) beside
it. Sharding over ``torch.distributed`` is not ported yet."""

from .trainer import SPMDTrainer, adamw, chunked_lm_loss, lm_loss

__all__ = ["SPMDTrainer", "adamw", "chunked_lm_loss", "lm_loss"]
