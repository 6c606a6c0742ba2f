"""The attention kernels' share of their roofline (%): the larger of
FLOPs / peak and bytes / bandwidth of each attention call that the
traced unit's traffic needed, summed, over the device time of the
kernels named in portbench/attention/."""
from portbench.readers import attn_roofline as read  # noqa: F401
