"""The share of the traced window in which no operation ran on the card."""
from p2pbench import readers

read = readers.idle_pct
