"""Training throughput: the images of all peers in every step completed in
the window, over the window (host clock, ended by a synchronise)."""
from p2pbench import readers

read = readers.rate
