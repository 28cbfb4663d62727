from swarm_tpu_torch.server.app import main

main()
