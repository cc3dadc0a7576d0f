"""Surrogate search of the port: the search space, training, the GP and
the nested Bayesian optimization (counterpart of ``repro/nas``)."""
