from mcjax_torch.models.potentials import HardSphere, Potential, pair_interaction

__all__ = ["HardSphere", "Potential", "pair_interaction"]
