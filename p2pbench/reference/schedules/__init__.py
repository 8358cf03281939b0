"""The reference's rate of each schedule a cell can name:
``schedules/<name>.py`` has ``rate(spec) -> (step -> lr)``, steps from 0."""
