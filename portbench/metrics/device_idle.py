"""Share of the traced window with no device operation, %: read as
``device_idle.<cells>`` (``.sample``, ``.step``), one name a kind of
cell."""
from portbench import readers


def read(facts):
    return readers.idle(facts)
