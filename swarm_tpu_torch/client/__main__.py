import sys

from swarm_tpu_torch.client.cli import main

sys.exit(main())
