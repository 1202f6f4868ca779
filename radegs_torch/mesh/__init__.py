"""Mesh extraction on the port: TSDF fusion (``tsdf``), Marching Tetrahedra
over the Gaussians' seeds with the integrate kernels (``extract_tetra``),
contracted-space extraction for unbounded scenes (``unbounded``), and mesh
culling / post-processing (``culling``)."""

from radegs_torch.mesh.culling import (
    cull_mesh,
    keep_largest_component,
    mesh_depth_map,
    point_visibility,
    post_process_mesh,
)
from radegs_torch.mesh.tetmesh import marching_tetrahedra
from radegs_torch.mesh.unbounded import extract_mesh_unbounded

__all__ = [
    "marching_tetrahedra",
    "cull_mesh",
    "keep_largest_component",
    "mesh_depth_map",
    "point_visibility",
    "post_process_mesh",
    "extract_mesh_unbounded",
]
