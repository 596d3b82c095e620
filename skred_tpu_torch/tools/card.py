"""The card a tool runs on: its name and power limit as nvidia-smi gives
them, and the check every tool makes of its ``--device``: the tools run
on the card unless the caller passes ``--device cpu``, and with no card
they stop with an error line, never falling back to the CPU."""

import subprocess
import sys

import torch


def card_info(device) -> dict:
    """The card's name and power limit as nvidia-smi gives them."""
    if torch.device(device).type != "cuda":
        return {"name": str(device), "power_limit": None}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in out.split(","))
    return {"name": name, "power_limit": limit}


def require(device, prog: str, fail=None) -> None:
    """Exit 2 with an error line when ``device`` is a card and there is
    none: ``fail(message, 2)`` where the caller reports errors its own
    way, else a line on stderr."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        msg = (f"{prog}: torch.cuda.is_available() is false: this runs on "
               f"the card (pass --device cpu for the CPU)")
        if fail is not None:
            fail(msg, 2)
        print(msg, file=sys.stderr, flush=True)
        raise SystemExit(2)


def sync(device):
    """``torch.cuda.synchronize`` on a card, nothing on the CPU."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
