"""Observability of the port: the fabric counters of a profiled run
(:class:`FabricProfile`)."""
from repro_torch.obs.profile import FabricProfile

__all__ = ["FabricProfile"]
