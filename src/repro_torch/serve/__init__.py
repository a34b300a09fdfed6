"""Serving of the port: the LM ``ServeEngine`` (``serve.engine``).  The
counting service comes with ROADMAP queue 1 item 8."""
