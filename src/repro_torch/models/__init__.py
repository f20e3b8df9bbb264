"""The language model of the serving data plane: config, layers, LM."""
