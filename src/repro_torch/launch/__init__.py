"""Entry points of the torch port: ``serve_async`` (Poisson-traffic
cascade serving), ``serve`` (the batch cascade wrapper), ``train`` (LM
and LtC training) and the step functions of ``steps``."""
