"""``python -m swarm_tpu_torch.worker --server-url … --api-key … --worker-id …
--modules-dir … --max-jobs N [--device cpu]``"""

from swarm_tpu_torch.worker.runtime import main

main()
