"""The program's side of each learning-rate schedule a cell can name:
``schedules/<name>.py`` has ``program(spec)``, the port's schedule for the
cell's ``schedule`` entry. Its reference is ``reference/schedules/<name>.py``."""
