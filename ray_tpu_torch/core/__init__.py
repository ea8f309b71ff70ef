"""Runtime pieces of the port (counterpart of ``ray_tpu.core``): so far the
serve series of the runtime's self-metrics."""
