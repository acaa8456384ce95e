"""The tail scan's exact refreshes: the factorization from the
row-removed statistics; cycles a row (thread 0's clock64() at the row
loop's barriers), in the traced window's last tail run again after
it."""
from portbench import spans


def read(facts):
    return spans.scan_cycles(facts, "refresh")
