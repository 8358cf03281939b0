"""Host milliseconds inside one `P2PTrainer.step` call, no synchronise: the
enqueue path (median over the window's steps)."""
from p2pbench import readers

read = readers.host_ms
