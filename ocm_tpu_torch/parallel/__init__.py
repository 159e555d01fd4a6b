"""Multi-card paths on ``torch.distributed`` (port of ``ocm_tpu/parallel``):
the mesh, sample-sharded SIMCA, data-parallel VAE training and config- and
class-sharded sweeps."""

from ocm_tpu_torch.parallel import mesh, simca_dist, sweep_dist, train_dist

__all__ = ["mesh", "simca_dist", "sweep_dist", "train_dist"]
