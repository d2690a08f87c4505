"""Incremental-learning state bookkeeping (own copy of the JAX package's
``states.py``): a scenario such as ``[15, 1]`` or ``[10, 10]`` expands
into per-state records of *new* and *knowing* (cumulative) classes over a
fixed class ordering.

  * classes are the dataset's category names sorted alphabetically, with
    an optional seeded shuffle;
  * scenario entries may be ints, numeric strings, or literal class names
    (a class name claims the next slot for that class and counts as 1);
  * the exact scenario ``['15','1']`` puts ``train`` in state 1;
  * state k's ``knowing`` classes = state k-1's knowing + state k's new,
    in that order; class ids come from the dataset mapping and the new
    block is id-sorted within itself.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Union

ScenarioEntry = Union[int, str]


@dataclass
class StateInfo:
    """One incremental state: the classes it introduces and all it knows."""
    index: int
    new_names: List[str] = field(default_factory=list)
    new_ids: List[int] = field(default_factory=list)
    knowing_names: List[str] = field(default_factory=list)
    knowing_ids: List[int] = field(default_factory=list)

    @property
    def num_new_class(self) -> int:
        return len(self.new_names)

    @property
    def num_knowing_class(self) -> int:
        return len(self.knowing_names)

    @property
    def num_past_class(self) -> int:
        return self.num_knowing_class - self.num_new_class

    @property
    def past_names(self) -> List[str]:
        return self.knowing_names[: self.num_past_class]

    @property
    def past_ids(self) -> List[int]:
        return self.knowing_ids[: self.num_past_class]


class ILStates:
    """Expands a scenario into per-state class bookkeeping.

    Args:
      class_names: ALL category names in the dataset (any order).
      name_to_id: dataset category name -> category id.
      scenario: e.g. ``[20]``, ``["15", "1"]``, ``[10, 10]``,
        ``[19, "tvmonitor"]``.
      shuffle_class: shuffle the class order (seeded, reproducible).
    """

    def __init__(
        self,
        class_names: Sequence[str],
        name_to_id: Dict[str, int],
        scenario: Sequence[ScenarioEntry],
        shuffle_class: bool = False,
        shuffle_seed: int = 0,
    ):
        self.name_to_id = dict(name_to_id)
        classes = sorted(class_names)
        if shuffle_class:
            rng = random.Random(shuffle_seed)
            rng.shuffle(classes)

        scenario = list(scenario)
        counts: List[int] = []
        if [str(s) for s in scenario] == ["15", "1"]:
            # the special case: state 1 learns 'train'
            counts = [15, 1]
            if "train" in classes:
                i = classes.index("train")
                classes[15], classes[i] = classes[i], classes[15]
        else:
            cursor = 0
            for entry in scenario:
                if isinstance(entry, str) and not entry.lstrip("-").isdigit():
                    # A literal class name claims the slot at `cursor`.
                    if entry not in classes:
                        raise ValueError(f"unknown class in scenario: {entry!r}")
                    i = classes.index(entry)
                    classes[cursor], classes[i] = classes[i], classes[cursor]
                    counts.append(1)
                    cursor += 1
                else:
                    n = int(entry)
                    counts.append(n)
                    cursor += n
            if cursor > len(classes):
                raise ValueError(
                    f"scenario {scenario} needs {cursor} classes, dataset has {len(classes)}"
                )

        self.class_order = classes
        self.total_class_num = sum(counts)
        self.states: List[StateInfo] = []

        total = 0
        for idx, num in enumerate(counts):
            st = StateInfo(index=idx)
            new_names = classes[total : total + num]
            total += num
            st.new_names = list(new_names)
            # the new block is sorted by category id
            st.new_ids = sorted(self.name_to_id[n] for n in new_names)
            if idx == 0:
                st.knowing_names = list(st.new_names)
                st.knowing_ids = list(st.new_ids)
            else:
                prev = self.states[idx - 1]
                st.knowing_names = prev.knowing_names + st.new_names
                st.knowing_ids = prev.knowing_ids + st.new_ids
            self.states.append(st)

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.states)

    def __getitem__(self, key: int) -> StateInfo:
        if not -len(self.states) <= key < len(self.states):
            raise IndexError(
                f"state {key} does not exist: scenario has {len(self.states)} "
                f"state(s) (0..{len(self.states) - 1})"
            )
        return self.states[key]

    def label_map(self) -> Dict[int, int]:
        """Category id -> contiguous training label, stable across states.

        Built from the FINAL state's knowing order so a class keeps its
        label index as states advance.
        """
        final = self.states[-1]
        return {cat_id: i for i, cat_id in enumerate(final.knowing_ids)}

    def inverse_label_map(self) -> Dict[int, int]:
        return {v: k for k, v in self.label_map().items()}
