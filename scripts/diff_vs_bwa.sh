#!/usr/bin/env bash
# Diff tpubwa output against a stock `bwa` binary the moment one
# exists (VERDICT round-3 item 7: the BASELINE headline metric "SAM
# equality rate" is environmentally blocked here — no network, no bwa
# binary — so this script is shipped ready-to-run for any environment
# that has one).
#
# Usage:
#   scripts/diff_vs_bwa.sh <bwa-binary> [workdir]
#
# Runs both aligners on the frozen golden corpus (tests/golden/) in
# SE and PE mode, normalizes volatile header lines (@PG), and reports
# a per-record field-by-field equality rate.  Exit 0 iff bit-identical.
set -euo pipefail

BWA=${1:?usage: diff_vs_bwa.sh <bwa-binary> [workdir]}
ROOT=$(cd "$(dirname "$0")/.." && pwd)
WORK=${2:-$(mktemp -d)}
GOLD="$ROOT/tests/golden"

echo "[diff] workdir: $WORK"
cd "$WORK"

# 1. both aligners index the SAME frozen FASTA
cp "$GOLD/ref.fa" ref.fa
"$BWA" index -p bwa_idx ref.fa 2> bwa_index.log
python -m tpubwa index -p ours_idx ref.fa 2> ours_index.log

norm() { grep -v '^@PG' "$1" | LC_ALL=C sort; }

rate() {  # rate <a.sam> <b.sam> <label>
    local a b total same
    a=$(norm "$1"); b=$(norm "$2")
    total=$(printf '%s\n' "$a" | wc -l)
    same=$(comm -12 <(printf '%s\n' "$a") <(printf '%s\n' "$b") | wc -l)
    echo "[diff] $3: $same/$total records identical" \
         "($(python -c "print(f'{$same/$total:.4%}')"))"
    [ "$same" = "$total" ]
}

# 2. SE
"$BWA" mem bwa_idx "$GOLD/se.fq" > bwa_se.sam 2> bwa_se.log
python -m tpubwa mem ours_idx "$GOLD/se.fq" > ours_se.sam 2> ours_se.log
rate bwa_se.sam ours_se.sam SE || FAIL=1

# 3. PE (pin chunk semantics: one chunk => identical pestat window)
"$BWA" mem bwa_idx "$GOLD/pe1.fq" "$GOLD/pe2.fq" > bwa_pe.sam \
    2> bwa_pe.log
python -m tpubwa mem ours_idx "$GOLD/pe1.fq" "$GOLD/pe2.fq" \
    > ours_pe.sam 2> ours_pe.log
rate bwa_pe.sam ours_pe.sam PE || FAIL=1

# 4. fastmap (seeding-stage equality)
"$BWA" fastmap bwa_idx "$GOLD/se.fq" > bwa_fm.txt 2>/dev/null || true
python -m tpubwa fastmap ours_idx "$GOLD/se.fq" > ours_fm.txt
if [ -s bwa_fm.txt ]; then
    if diff -q bwa_fm.txt ours_fm.txt > /dev/null; then
        echo "[diff] fastmap: identical"
    else
        echo "[diff] fastmap: DIFFERS (diff bwa_fm.txt ours_fm.txt)"
        FAIL=1
    fi
fi

if [ "${FAIL:-0}" = 1 ]; then
    echo "[diff] NOT bit-identical — inspect $WORK"
    exit 1
fi
echo "[diff] bit-identical on the golden corpus"
