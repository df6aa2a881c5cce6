"""Rank functions of ``test_torch_training.py``'s spawned gloo ranks.

Every spawned rank imports the module of the function it runs; this one
imports no JAX (about 3 s a rank on a small host), unlike the test file.
"""
import torch

from repro_torch.training import compression


def psum_rank(mesh, g_all, n_seeds):
    """Each rank reduces its row of ``g_all`` with both compressed
    all-reduces, once a seed (its generator seeded by seed and rank)."""
    g = torch.from_numpy(g_all[mesh.rank])
    out = {"exact": [], "max": []}
    for seed in range(n_seeds):
        gen = torch.Generator().manual_seed(seed * 1000 + mesh.rank)
        out["exact"].append(compression.compressed_psum_exact_scale(
            {"g": g}, mesh, gen)["g"].numpy())
        out["max"].append(compression.compressed_psum([g], mesh, gen)[0].numpy())
    return out
