"""What the readers of K3's lean instances share: K3 in the path tracer
(``traverse_q_kernel<true, *>``, closest-hit and any-hit over a
``QPTScene``), told apart from its full instance and from K2."""

from __future__ import annotations

import re

K3PT = re.compile(r"traverse_q_kernel<\s*true\s*,")
