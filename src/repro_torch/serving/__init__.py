"""Paged serving data plane of the port: page pool, engine, runner."""
