"""The device's idle share of the traced span (%): 1 - the union of its
activity intervals over the span."""
from portbench.readers import device_idle as read  # noqa: F401
