"""The reference's update of each optimizer a cell can name:
``optimizers/<name>.py`` has ``zero_state(p)`` and ``update(g, state, lr,
t, opt) -> (step, state)``: the amount to subtract from a leaf at the
``t``-th step (from 1) and the leaf's new state."""
