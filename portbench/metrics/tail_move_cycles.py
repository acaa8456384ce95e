"""The tail scan's moves: each row's entry and exit (the removal and
add-back moves of the factor and of G), the downdate test and the drift
probe; cycles a row (thread 0's clock64() at the row loop's barriers),
in the traced window's last tail run again after it."""
from portbench import spans


def read(facts):
    return spans.scan_cycles(facts, "move")
