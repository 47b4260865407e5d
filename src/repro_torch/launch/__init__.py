"""Entry points of the torch port (``serve_async``: Poisson-traffic
cascade serving)."""
