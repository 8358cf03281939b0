"""The reference's codec of each exchange a cell can name:
``exchanges/<name>.py`` has ``combine(bank, ex, generator)``: a (peers, n)
bank of the peers' gradients of one leaf, in the wire's layout, to (the
mix every peer steps with (n,), each peer's own decoded image (peers,
n)). ``generator`` is the codec's, which the benchmark hands both sides."""
