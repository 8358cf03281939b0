"""The plain mean: every peer's gradient as it is."""


def combine(bank, ex: dict, generator):
    return bank.mean(dim=0), bank
