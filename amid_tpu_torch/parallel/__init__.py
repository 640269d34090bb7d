"""The parallel layer — the counterpart of `amid_tpu/parallel/`: mesh and
multi-node training over `torch.distributed` (`context`, `mesh`,
`collectives`, `embedding`, `spmd`, `distributed`)."""
