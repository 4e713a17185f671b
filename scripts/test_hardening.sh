#!/bin/bash
# Hardening test suite — the reference's test_hardening.sh adapted to drive
# this framework's CLI (same five tests, same assertions).
set -e
REPO="$(cd "$(dirname "$0")/.." && pwd)"
TFFT="$REPO/bin/turtlefft"
WORK="${1:-$REPO/.cache/hardening}"
# The properties under test are control-flow (KDF cost, magic check, flags),
# not device speed: run on CPU so the suite is hermetic (no device start-up
# per invocation, no contention with a process that holds the card).
# Override with JAX_PLATFORMS=gpu.
export JAX_PLATFORMS="${JAX_PLATFORMS:-cpu}"
mkdir -p "$WORK"
cd "$WORK"

echo "=== TurtleFFT (JAX) Hardening Test Suite ==="

if [ ! -f host.png ]; then
    python3 "$REPO/tools/gen_png.py" host.png
fi

echo "Test 1: Basic round-trip with hardened defaults (600k iterations)"
time "$TFFT" embed --in host.png --out stego1.png --secret "Hello World!" --pass "test123"
out=$(time "$TFFT" extract --in stego1.png --pass "test123")
[ "$out" = "Hello World!" ] || { echo "FAIL: got '$out'"; exit 1; }
echo "v Test 1 passed"

echo "Test 2: Long message with hardened settings"
MSG="TurtleFFT hardened system with 600k PBKDF2 iterations."
time "$TFFT" embed --in host.png --out stego2.png --secret "$MSG" --pass "SecurePassword123!"
out=$("$TFFT" extract --in stego2.png --pass "SecurePassword123!")
[ "$out" = "$MSG" ] || { echo "FAIL: got '$out'"; exit 1; }
echo "v Test 2 passed"

echo "Test 3: Wrong password detection (should fail fast)"
if "$TFFT" extract --in stego1.png --pass "WrongPassword" 2>err.txt; then
    echo "FAIL: wrong password accepted"; exit 1
fi
grep -q "Magic not found" err.txt || { echo "FAIL: expected 'Magic not found'"; cat err.txt; exit 1; }
echo "v Test 3 passed (detected wrong password)"

echo "Test 4: Custom KDF iterations"
time "$TFFT" embed --in host.png --out stego3.png --secret "Faster test" --pass "test" --pbkdf2_iter 50000
out=$("$TFFT" extract --in stego3.png --pass "test" --pbkdf2_iter 50000)
[ "$out" = "Faster test" ] || { echo "FAIL"; exit 1; }
echo "v Test 4 passed"

echo "Test 5: Experimental features (may fail - expected)"
"$TFFT" embed --in host.png --out stego4.png --secret "Test" --pass "test" --pbkdf2_iter 50000 --adaptive_alpha 1 2>&1 || true
"$TFFT" extract --in stego4.png --pass "test" --pbkdf2_iter 50000 --adaptive_alpha 1 2>&1 || true

echo "=== All Tests Complete ==="
