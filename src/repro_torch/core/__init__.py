"""The routing loop on tensors: the trace evaluator (``fitness``), NSGA-II
(``nsga2``, ``pareto``), objectives, policies and baselines."""
