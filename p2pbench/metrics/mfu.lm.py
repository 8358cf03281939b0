"""Model FLOPs of a step over its time in the window, as a share of the
H100's peak in the precision the model computes in (the family's
`train_flops`; remat's recomputation not counted)."""
from p2pbench import readers

read = readers.mfu
