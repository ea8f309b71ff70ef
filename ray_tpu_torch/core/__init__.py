"""Runtime pieces of the port (counterpart of ``ray_tpu.core``): the actor
layer of the Train gang, object serialization with tensor staging, and the
serve series of the runtime's self-metrics."""
