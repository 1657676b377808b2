import sys

from cdk.cli import main

sys.exit(main())
