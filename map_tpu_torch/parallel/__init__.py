"""The parallel layer: data-parallel ranks and row-sharded vocabulary tables
over torch.distributed. Counterpart: `map_tpu/parallel/` (mesh, context,
sharding, embedding)."""
