"""repro_torch.training — the training path (the port of
``repro/training``): the deterministic data stream (``data``), AdamW with
float32 / bfloat16 / int8 moments (``optimizer``), the train steps
(``train_loop``), the DDP gradient exchange over the allreduce star forest
(``ddp``), checkpoints in the reference's format (``checkpoint``) and the
restart loop (``fault``).  ``pytree`` walks nested containers in
``jax.tree_util``'s order."""

from . import checkpoint, data, ddp, fault, optimizer, pytree, train_loop

__all__ = ["checkpoint", "data", "ddp", "fault", "optimizer", "pytree",
           "train_loop"]
