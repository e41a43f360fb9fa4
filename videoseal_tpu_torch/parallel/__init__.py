"""The GAN training step and its mesh, counterpart of ``videoseal_tpu/parallel``
(whose JAX sharding specs, ``replicated`` and ``batch_sharding``, have no
counterpart here)."""

from .mesh import make_mesh
from .trainer import TrainerModules, TrainState, create_train_state, make_train_step

__all__ = ["TrainState", "TrainerModules", "create_train_state", "make_mesh",
           "make_train_step"]
