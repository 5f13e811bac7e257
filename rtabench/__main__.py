import sys

from rtabench.harness import main

sys.exit(main())
