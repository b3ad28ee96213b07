"""The CAM kernels' share of their roofline in the bulk cells (``readers.cam_roofline``)."""

from xbench.readers import cam_roofline


def read(rec):
    return cam_roofline(rec)
