import sys

from tpu_mpi_tests_torch.workloads.runner import main

sys.exit(main())
