"""The SIBR network viewer bridge (port of ``radegs_tpu/viewer``)."""

from radegs_torch.viewer.network_gui import NetworkGUI

__all__ = ["NetworkGUI"]
