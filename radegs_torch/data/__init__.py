"""Dataset readers (COLMAP, Blender / NeRF-synthetic) and the ``Scene`` that
puts a dataset's cameras and ground-truth images on the device."""

from radegs_torch.data.readers import (
    CameraInfo,
    SceneInfo,
    load_scene_info,
    read_blender_scene,
    read_colmap_scene,
)
from radegs_torch.data.scene import Scene

__all__ = [
    "CameraInfo",
    "SceneInfo",
    "Scene",
    "load_scene_info",
    "read_colmap_scene",
    "read_blender_scene",
]
