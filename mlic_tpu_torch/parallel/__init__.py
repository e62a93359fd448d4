"""Scale-out: data-parallel training over ``torch.distributed``
(``mesh``) and the codec sharded over a list of devices (``serving``)."""
