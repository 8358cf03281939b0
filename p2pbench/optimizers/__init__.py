"""The program's side of each optimizer a cell can name:
``optimizers/<name>.py`` has ``program(opt)``, the port's optimizer for the
cell's ``optimizer`` entry, and ``first_gradient(opt_state, opt)``, the
first step's gradient as the optimizer got it, read from its state after
that step. Its reference is ``reference/optimizers/<name>.py``."""
