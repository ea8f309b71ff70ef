"""Host-side utilities of the port (counterpart of ``ray_tpu.util``): the
dispatch profiler of the serve engine, process-local tracing, the chaos
plan and named collective groups over host arrays (`collective`)."""
