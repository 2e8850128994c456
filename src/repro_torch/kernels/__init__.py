"""Hand-written Hopper kernels, their wrappers and their plain versions.

Public ops are in :mod:`repro_torch.kernels.ops`; the plain versions in
:mod:`repro_torch.kernels.ref`. Each wrapper module (for example
:mod:`repro_torch.kernels.moe_gmm`) keeps its launch counter.
"""
