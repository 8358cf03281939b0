"""What differs between the families of configurations the benchmark runs:
how a family's global batches are drawn, its loss on the program's side,
its unit of work and its model FLOPs. A configuration file names its
family; ``harness.family`` loads the module of that name."""
