"""Host data layer: MDS shards, streaming datasets, the LAION and COCO
readers and the DataLoader (copies of the JAX package's jax-free modules;
the loader takes its rank from torch.distributed)."""
