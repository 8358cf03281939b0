"""The program's side of each exchange a cell can name: ``exchanges/<name>.py``
has ``topology(ex)``, the keyword arguments of the program's ``Topology``
for the cell's ``exchange`` entry, and ``bound_s(costs, peers, n, ex,
ran)``, the least device time of the codec's launches on one leaf of
``n`` entries (``ran``: the kernel wrappers that launched in the traced
steps), and ``KERNELS``, a pattern of its kernels' symbols in the device
trace (None where it launches none of its own). Its reference is ``reference/exchanges/<name>.py``."""
