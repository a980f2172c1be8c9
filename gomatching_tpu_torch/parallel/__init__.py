"""Data parallelism of the port on ``torch.distributed`` (counterpart of
``gomatching_tpu/parallel``): ``mesh`` holds the group helpers, ``launch`` spawns one
process per card, ``dryrun`` runs one data-parallel step."""
