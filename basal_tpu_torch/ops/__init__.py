"""Device ops of the port: lane primitives, the count core and its CUDA kernel."""
