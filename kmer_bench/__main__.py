import sys

from kmer_bench.run import main

sys.exit(main())
