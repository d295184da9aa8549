"""The distributed training runtime: one node per ``torch.distributed``
rank, gossip as the slot plan's point-to-point messages (the port of
``repro/dist``)."""
