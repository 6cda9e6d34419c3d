"""Device meshes: data, tensor and FSDP parallelism."""
