"""The whole step's share of the card's bf16 peak (%): the model FLOPs
the traced unit's traffic needed over the traced span."""
from portbench.readers import mfu as read  # noqa: F401
