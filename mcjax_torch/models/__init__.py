from mcjax_torch.models.potentials import (WCA, HardSphere, LennardJones,
                                           Morse, PolynomialPotential,
                                           Potential, SoftSphere, SquareWell,
                                           Yukawa, fit_pair_polynomial,
                                           pair_interaction,
                                           potential_from_dict,
                                           potential_to_dict)

__all__ = ["HardSphere", "LennardJones", "Morse", "PolynomialPotential",
           "Potential", "SoftSphere", "SquareWell", "WCA", "Yukawa",
           "fit_pair_polynomial", "pair_interaction", "potential_from_dict",
           "potential_to_dict"]
