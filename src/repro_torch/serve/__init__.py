"""Serving of the port: the LM ``ServeEngine`` (``serve.engine``) and the
counting service (``serve.counting``: ``CountingService`` over cached
engines, with adaptive stopping, failure semantics and graphlet profiles).
The asynchronous front-end comes with a later slice (ROADMAP queue 1 item
8)."""
