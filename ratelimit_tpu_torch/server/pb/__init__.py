"""Generated protobuf packages (scripts/gen_protos.sh).

protoc emits absolute imports (``from envoy.type.v3 import ...``), so
this directory adds itself to sys.path on first import.
"""

import os
import sys

_here = os.path.dirname(__file__)
if _here not in sys.path:
    sys.path.insert(0, _here)
