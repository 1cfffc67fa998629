"""`python -m repro_torch.train`: see `repro_torch.train`."""
from repro_torch.train import main

main()
