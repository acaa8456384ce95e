"""The tail scan's bit flips: the rss pass with its entry and exit;
cycles a row (thread 0's clock64() at the row loop's barriers), in the
traced window's last tail run again after it."""
from portbench import spans


def read(facts):
    return spans.scan_cycles(facts, "flip")
