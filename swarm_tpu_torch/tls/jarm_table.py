"""Default upstream-JARM cipher-order table (config data).

The upstream JARM scheme (Salesforce) encodes a server's chosen cipher
as its zero-padded 1-based hex index into one fixed, publicly
specified cipher-order list — the ``cipher_bytes`` order of the public
jarm reference implementation. That order is public-spec CONFIG DATA
(a list of IANA cipher-suite code points), reconstructed here so the
upstream-comparable ``jarm`` field populates out of the box
(BASELINE config #5).

Provenance and the honesty bound: this environment has no network
egress and no upstream copy on disk, so the list below is a
reconstruction of the public constant — ascending IANA code-point
order within each prefix block (0x00xx, 0xc0xx, 0xccxx) with the
TLS 1.3 suites (0x13xx) appended last, which is the upstream list's
documented shape. The operator override ``SWARM_JARM_CIPHER_TABLE``
(swarm_tpu_torch/tls/jarm.py) remains authoritative: installing a table
extracted from the upstream repo replaces this default entirely, and
a deployment that needs certified bit-level interop with public JARM
feeds should do exactly that. Structural invariants (entry format,
uniqueness, block ordering, TLS1.3 tail) are pinned by
tests/test_tls_jarm.py on the JAX package's copy, and
tests/test_torch_tls.py holds this copy equal to it.
"""

from __future__ import annotations

#: Upstream cipher-order list: 2-byte IANA cipher-suite code points as
#: lowercase 4-hex strings, in upstream encoding order.
DEFAULT_UPSTREAM_TABLE: tuple = (
    # SSL/TLS legacy + TLS 1.2 block (0x00xx), ascending
    "0004", "0005", "0007", "000a", "0016",
    "002f", "0033", "0035", "0039", "003c",
    "003d", "0041", "0045", "0067", "006b",
    "0084", "0088", "009a", "009c", "009d",
    "009e", "009f", "00ba", "00be", "00c0",
    "00c4",
    # ECDHE/ECDSA + CCM block (0xc0xx), ascending
    "c007", "c008", "c009", "c00a", "c011",
    "c012", "c013", "c014", "c023", "c024",
    "c027", "c028", "c02b", "c02c", "c02f",
    "c030", "c060", "c061", "c072", "c073",
    "c076", "c077", "c09c", "c09d", "c09e",
    "c09f", "c0a0", "c0a1", "c0a2", "c0a3",
    "c0ac", "c0ad", "c0ae", "c0af",
    # ChaCha20-Poly1305 block (0xccxx)
    "cc13", "cc14", "cca8", "cca9",
    # TLS 1.3 suites, appended last (upstream's documented tail)
    "1301", "1302", "1303", "1304", "1305",
)
