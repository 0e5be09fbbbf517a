"""Multi-chip execution: postings sharded over a device mesh, top-k
merged with collectives."""
