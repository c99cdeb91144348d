"""Hash functions from the paper.

``TWAHash(L, Ticket) = uintptr_t(L) + Ticket * 17`` — the intentionally
*ticket-aware* hash: as the ticket advances by 1 the index strides by 17
(coprime with the power-of-two table), marching through the whole gamut of
buckets before repeating and keeping numerically-adjacent tickets on
different cache lines.  ``Mix32A`` is the general-purpose supplementary hash
for address-based (non-ticket) keys.
"""

from __future__ import annotations

MASK32 = (1 << 32) - 1

# Paper's multiplicative stride. Coprime with any power-of-two table size.
TICKET_STRIDE = 17

# Paper's Mix32A constant.
MIX32KA = 0x9ABE94E3


def twa_hash(obj_addr: int, ticket: int, stride: int = TICKET_STRIDE) -> int:
    """uint32 TWAHash — address + ticket*17 (mod 2^32)."""
    return (obj_addr + (ticket & MASK32) * stride) & MASK32


def twa_hash_paired(obj_addr: int, ticket: int) -> int:
    """Paper's ``Ticket >>= 1`` preconditioning variant: groups adjacent
    tickets into pairs → pipelined early-wakeup (more futile wakeups, but
    "near" successors warm up early)."""
    return twa_hash(obj_addr, (ticket & MASK32) >> 1)


def twa_hash_subpage(obj_addr: int, ticket: int, subpage_bits: int = 6) -> int:
    """Paper's sub-page variant: upper ticket bits select a logical sub-page,
    lower bits are hashed within it — sequential tickets "orbit" inside one
    sub-page before moving on (TLB-friendly, Z-order-like)."""
    t = ticket & MASK32
    page = t >> subpage_bits
    low = t & ((1 << subpage_bits) - 1)
    return (obj_addr + (page << subpage_bits) + (low * TICKET_STRIDE & ((1 << subpage_bits) - 1))) & MASK32


def mix32a(v: int) -> int:
    """Paper's Mix32A avalanche hash (for arbitrary address keys)."""
    v &= MASK32
    v = ((v ^ (v >> 16)) * MIX32KA) & MASK32
    v = ((v ^ (v >> 16)) * MIX32KA) & MASK32
    return (v ^ (v >> 16)) & MASK32


def index_for(key: int, table_size: int) -> int:
    assert table_size > 0 and (table_size & (table_size - 1)) == 0, "power of two"
    return key & (table_size - 1)
