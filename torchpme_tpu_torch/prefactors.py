"""Unit-system prefactors converting from Gaussian units.

Counterpart of :mod:`torchpme_tpu.prefactors`; pass one of these as the
``prefactor`` of any potential.

Example
-------
>>> import torch
>>> from torchpme_tpu_torch import CoulombPotential, prefactors
>>> pot = CoulombPotential(prefactor=prefactors.eV_A)
>>> print(f"{float(pot.from_dist(torch.tensor(1.0))):.4f}")  # eV at r = 1 Å
14.3996
"""

#: Conversion factor from Gaussian units to SI units
SI = 2.3070775523417355e-28

#: Conversion factor from Gaussian units to electron volts / Angstroms
eV_A = 14.399645478425667

#: Conversion factor from Gaussian units to kilocalories per mole / Angstroms
kcalmol_A = 332.0637132991921

#: Conversion factor from Gaussian units to kilojoules per mole / Angstroms
kJmol = 1389.3545764438197
