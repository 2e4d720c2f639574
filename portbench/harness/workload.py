"""What every driver shares: the seeded sample of the window's calls whose
answers the check compares, and the interface the runner drives.

A driver (``portbench/drivers/<name>.py``) defines ``Workload``, a
subclass that sets ``unit`` and implements ``setup``, ``call``,
``units_of``, ``expected`` and ``compare``; ``control`` where it has
one. A kernel's roofline counts its own work from the cell's configuration
and traffic (``portbench/roofline/<kernel>.py``), so a driver reports none.
"""

from __future__ import annotations

from portbench.harness import data


class Workload:
    """One cell of a driver's kind.

    Args:
        config: the configuration file's object.
        traffic: the traffic file's object; its ``check`` holds ``calls``
            (calls sampled from the seed among the window's first
            ``within``; the window's last call is always kept) and, where
            a call has many answers, ``per_call`` (answers compared in
            each kept call).
        seed: the run's seed; device: where the program runs.
    """

    unit = "units"

    def __init__(self, config: dict, traffic: dict, seed: int, device, log=print):
        self.config = config
        self.traffic = traffic
        self.seed = seed
        self.device = device
        self.log = log
        check = traffic["check"]
        self.sampled = set(data.sample_calls(seed, check["within"], check["calls"]))
        self.kept = {}
        self.last = None

    # ----------------------------------------------------------- the window

    def setup(self) -> None:
        """Build the cell's inputs and the program's objects."""
        raise NotImplementedError

    def warm(self) -> None:
        """Serve the cell's own shapes once each before the window."""
        for i in range(self.traffic.get("warm_calls", 2)):
            self.call(i)

    def call(self, i: int):
        """Serve call ``i`` of the window through the program's entry."""
        raise NotImplementedError

    def units_of(self, i: int) -> int:
        raise NotImplementedError

    def keep(self, i: int, out) -> None:
        if i in self.sampled:
            self.kept[i] = out
        self.last = (i, out)

    def free(self) -> None:
        """Drop the program's state (the kept answers stay)."""

    # ------------------------------------------------------------ the check

    def answers(self) -> dict:
        """{call: answers} that the check compares."""
        kept = dict(self.kept)
        if self.last is not None:
            kept[self.last[0]] = self.last[1]
        return kept

    def expected(self, calls) -> dict:
        """{call: the reference's answers} for ``calls``."""
        raise NotImplementedError

    def compare(self, got: dict, want: dict) -> dict:
        """{check name: {"value": v, "limit": l}}; a run is correct when
        every v <= l."""
        raise NotImplementedError

    def check(self) -> dict:
        got = self.answers()
        return self.compare(got, self.expected(sorted(got)))

    def control(self, calls) -> dict:
        """{call: answers} of the control: the reference in the program's
        place, computed with the cheaper arithmetic that breaks one of the
        configuration's guarantees."""
        raise NotImplementedError
