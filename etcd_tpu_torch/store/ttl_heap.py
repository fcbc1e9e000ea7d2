"""Min-heap of expiring nodes with a position map for O(log n)
update/remove (reference store/ttl_key_heap.go)."""

from __future__ import annotations


class TTLKeyHeap:
    def __init__(self):
        self.array: list = []
        self.key_map: dict = {}

    def __len__(self) -> int:
        return len(self.array)

    def _less(self, i: int, j: int) -> bool:
        return self.array[i].expire_time < self.array[j].expire_time

    def _swap(self, i: int, j: int) -> None:
        a = self.array
        a[i], a[j] = a[j], a[i]
        self.key_map[a[i]] = i
        self.key_map[a[j]] = j

    def _up(self, i: int) -> None:
        while i > 0:
            parent = (i - 1) // 2
            if not self._less(i, parent):
                break
            self._swap(i, parent)
            i = parent

    def _down(self, i: int) -> None:
        n = len(self.array)
        while True:
            left = 2 * i + 1
            if left >= n:
                break
            small = left
            right = left + 1
            if right < n and self._less(right, left):
                small = right
            if not self._less(small, i):
                break
            self._swap(i, small)
            i = small

    def push(self, node) -> None:
        self.key_map[node] = len(self.array)
        self.array.append(node)
        self._up(len(self.array) - 1)

    def top(self):
        return self.array[0] if self.array else None

    def pop(self):
        if not self.array:
            return None
        top = self.array[0]
        self._remove_at(0)
        return top

    def update(self, node) -> None:
        i = self.key_map.get(node)
        if i is not None:
            self._remove_at(i)
            self.push(node)

    def remove(self, node) -> None:
        i = self.key_map.get(node)
        if i is not None:
            self._remove_at(i)

    def _remove_at(self, i: int) -> None:
        last = len(self.array) - 1
        node = self.array[i]
        if i != last:
            self._swap(i, last)
        self.array.pop()
        del self.key_map[node]
        if i < len(self.array):
            self._down(i)
            self._up(i)
