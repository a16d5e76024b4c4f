# Copy of redisearch_tpu/analysis/phonetics.py: the port imports nothing of the JAX package.
"""Double-metaphone phonetic hashing (reference: src/phonetic_manager.c,
deps/phonetics double_metaphone.c).

A complete implementation of Lawrence Philips' Double Metaphone (2000),
written from the published algorithm; emits BOTH the primary and secondary
codes.  Behavior is fuzz-verified against the reference's phonetic codes
over dictionary and random words (tests/test_json_cjk.py phonetics pins).

The match pipeline uses only the primary code — exactly like the
reference, whose tokenizer and query expander both pass NULL for the
secondary (src/tokenize.c:162, src/ext/default.c:648); the secondary
surfaces through the debug command (debug_commands.c:996).

Index time adds '\\x01'+code terms for PHONETIC(dm:en) TEXT fields; query
time expands tokens the same way, so words that sound alike match.
"""

from __future__ import annotations

_VOWELS = set("AEIOUY")


def _is_vowel(s: str, i: int) -> bool:
    return 0 <= i < len(s) and s[i] in _VOWELS


def _at(s: str, start: int, length: int, options) -> bool:
    """Is s[start:start+length] one of `options` (space-padded string)."""
    if start < 0:
        return False
    return s[start:start + length] in options


def _slavo_germanic(s: str) -> bool:
    return ("W" in s) or ("K" in s) or ("CZ" in s) or ("WITZ" in s)


def double_metaphone(word: str, max_len: int = 4) -> tuple[str, str]:
    """(primary, secondary) double-metaphone codes of `word`."""
    orig = "".join(c for c in word.upper() if c.isalpha())
    if not orig:
        return "", ""
    length = len(orig)
    last = length - 1
    s = orig + "     "  # pad so lookaheads never raise
    sg = _slavo_germanic(orig)

    pri: list[str] = []
    sec: list[str] = []

    def add(p: str, q: str | None = None) -> None:
        if q is None:
            q = p
        if p:
            pri.append(p)
        if q:
            sec.append(q)

    cur = 0
    # skip silent letters at the start
    if s[0:2] in ("GN", "KN", "PN", "WR", "PS"):
        cur = 1
    # initial X is pronounced Z e.g. Xavier
    if s[0] == "X":
        add("S")
        cur = 1

    while (len(pri) < max_len or len(sec) < max_len) and cur < length:
        c = s[cur]

        if c in _VOWELS:
            if cur == 0:
                add("A")
            cur += 1
            continue

        if c == "B":
            add("P")
            cur += 2 if s[cur + 1] == "B" else 1
            continue

        if c == "\xc7":  # Ç
            add("S")
            cur += 1
            continue

        if c == "C":
            # various germanic
            if (cur > 1 and not _is_vowel(s, cur - 2)
                    and _at(s, cur - 1, 3, ("ACH",))
                    and s[cur + 2] != "I"
                    and (s[cur + 2] != "E"
                         or _at(s, cur - 2, 6, ("BACHER", "MACHER")))):
                add("K")
                cur += 2
                continue
            # special case 'caesar'
            if cur == 0 and _at(s, cur, 6, ("CAESAR",)):
                add("S")
                cur += 2
                continue
            # italian 'chianti'
            if _at(s, cur, 4, ("CHIA",)):
                add("K")
                cur += 2
                continue
            if _at(s, cur, 2, ("CH",)):
                # 'michael'
                if cur > 0 and _at(s, cur, 4, ("CHAE",)):
                    add("K", "X")
                    cur += 2
                    continue
                # greek roots e.g. chemistry, chorus
                if (cur == 0
                        and (_at(s, cur + 1, 5, ("HARAC", "HARIS"))
                             or _at(s, cur + 1, 3,
                                    ("HOR", "HYM", "HIA", "HEM")))
                        and not _at(s, 0, 5, ("CHORE",))):
                    add("K")
                    cur += 2
                    continue
                # germanic, greek, or otherwise 'ch' for 'kh' sound
                if ((_at(s, 0, 4, ("VAN ", "VON "))
                     or _at(s, 0, 3, ("SCH",)))
                        # 'architect' but not 'arch', 'orchestra'
                        or _at(s, cur - 2, 6,
                               ("ORCHES", "ARCHIT", "ORCHID"))
                        or _at(s, cur + 2, 1, ("T", "S"))
                        or ((_at(s, cur - 1, 1, ("A", "O", "U", "E"))
                             or cur == 0)
                            # e.g. 'wachtler', 'wechsler', not 'tichner'
                            and _at(s, cur + 2, 1,
                                    ("L", "R", "N", "M", "B", "H", "F",
                                     "V", "W", " ")))):
                    add("K")
                else:
                    if cur > 0:
                        if _at(s, 0, 2, ("MC",)):
                            # e.g. "McHugh"
                            add("K")
                        else:
                            add("X", "K")
                    else:
                        add("X")
                cur += 2
                continue
            # e.g. 'czerny'
            if _at(s, cur, 2, ("CZ",)) and not _at(s, cur - 2, 4, ("WICZ",)):
                add("S", "X")
                cur += 2
                continue
            # e.g. 'focaccia'
            if _at(s, cur + 1, 3, ("CIA",)):
                add("X")
                cur += 3
                continue
            # double 'C', but not if e.g. 'McClellan'
            if _at(s, cur, 2, ("CC",)) and not (cur == 1 and s[0] == "M"):
                # 'bellocchio' but not 'bacchus'
                if (_at(s, cur + 2, 1, ("I", "E", "H"))
                        and not _at(s, cur + 2, 2, ("HU",))):
                    # 'accident', 'accede', 'succeed'
                    if ((cur == 1 and s[cur - 1] == "A")
                            or _at(s, cur - 1, 5, ("UCCEE", "UCCES"))):
                        add("KS")
                    # 'bacci', 'bertucci', other italian
                    else:
                        add("X")
                    cur += 3
                    continue
                else:  # Pierce's rule
                    add("K")
                    cur += 2
                    continue
            if _at(s, cur, 2, ("CK", "CG", "CQ")):
                add("K")
                cur += 2
                continue
            if _at(s, cur, 2, ("CI", "CE", "CY")):
                # italian vs. english
                if _at(s, cur, 3, ("CIO", "CIE", "CIA")):
                    add("S", "X")
                else:
                    add("S")
                cur += 2
                continue
            add("K")
            # name sent in 'mac caffrey', 'mac gregor'
            if _at(s, cur + 1, 2, (" C", " Q", " G")):
                cur += 3
            elif (_at(s, cur + 1, 1, ("C", "K", "Q"))
                  and not _at(s, cur + 1, 2, ("CE", "CI"))):
                cur += 2
            else:
                cur += 1
            continue

        if c == "D":
            if _at(s, cur, 2, ("DG",)):
                if _at(s, cur + 2, 1, ("I", "E", "Y")):
                    # e.g. 'edge'
                    add("J")
                    cur += 3
                    continue
                else:
                    # e.g. 'edgar'
                    add("TK")
                    cur += 2
                    continue
            if _at(s, cur, 2, ("DT", "DD")):
                add("T")
                cur += 2
                continue
            add("T")
            cur += 1
            continue

        if c == "F":
            cur += 2 if s[cur + 1] == "F" else 1
            add("F")
            continue

        if c == "G":
            if s[cur + 1] == "H":
                if cur > 0 and not _is_vowel(s, cur - 1):
                    add("K")
                    cur += 2
                    continue
                if cur < 3:
                    # 'ghislane', 'ghiradelli'
                    if cur == 0:
                        if s[cur + 2] == "I":
                            add("J")
                        else:
                            add("K")
                        cur += 2
                        continue
                # Parker's rule (with some further refinements)
                if ((cur > 1 and _at(s, cur - 2, 1, ("B", "H", "D")))
                        # e.g. 'bough'
                        or (cur > 2 and _at(s, cur - 3, 1, ("B", "H", "D")))
                        # e.g. 'broughton'
                        or (cur > 3 and _at(s, cur - 4, 1, ("B", "H")))):
                    cur += 2
                    continue
                else:
                    # e.g. 'laugh', 'McLaughlin', 'cough', 'gough',
                    # 'rough', 'tough'
                    if (cur > 2 and s[cur - 1] == "U"
                            and _at(s, cur - 3, 1,
                                    ("C", "G", "L", "R", "T"))):
                        add("F")
                    elif cur > 0 and s[cur - 1] != "I":
                        add("K")
                    cur += 2
                    continue
            if s[cur + 1] == "N":
                if cur == 1 and _is_vowel(s, 0) and not sg:
                    add("KN", "N")
                else:
                    # not e.g. 'cagney'
                    if not _at(s, cur + 2, 2, ("EY",)) \
                            and s[cur + 1] != "Y" and not sg:
                        add("N", "KN")
                    else:
                        add("KN")
                cur += 2
                continue
            # 'tagliaro'
            if _at(s, cur + 1, 2, ("LI",)) and not sg:
                add("KL", "L")
                cur += 2
                continue
            # -ges-, -gep-, -gel-, -gie- at beginning
            if cur == 0 and (s[cur + 1] == "Y"
                             or _at(s, cur + 1, 2,
                                    ("ES", "EP", "EB", "EL", "EY", "IB",
                                     "IL", "IN", "IE", "EI", "ER"))):
                add("K", "J")
                cur += 2
                continue
            # -ger-, -gy-
            if ((_at(s, cur + 1, 2, ("ER",)) or s[cur + 1] == "Y")
                    and not _at(s, 0, 6, ("DANGER", "RANGER", "MANGER"))
                    and not _at(s, cur - 1, 1, ("E", "I"))
                    and not _at(s, cur - 1, 3, ("RGY", "OGY"))):
                add("K", "J")
                cur += 2
                continue
            # italian e.g. 'biaggi'
            if (_at(s, cur + 1, 1, ("E", "I", "Y"))
                    or _at(s, cur - 1, 4, ("AGGI", "OGGI"))):
                # germanic
                if (_at(s, 0, 4, ("VAN ", "VON "))
                        or _at(s, 0, 3, ("SCH",))
                        or _at(s, cur + 1, 2, ("ET",))):
                    add("K")
                else:
                    # always soft if french ending
                    if _at(s, cur + 1, 4, ("IER ",)):
                        add("J")
                    else:
                        add("J", "K")
                cur += 2
                continue
            cur += 2 if s[cur + 1] == "G" else 1
            add("K")
            continue

        if c == "H":
            # only keep if first & before vowel or between 2 vowels
            if (cur == 0 or _is_vowel(s, cur - 1)) \
                    and _is_vowel(s, cur + 1):
                add("H")
                cur += 2
            else:  # also takes care of 'HH'
                cur += 1
            continue

        if c == "J":
            # obvious spanish, 'jose', 'san jacinto'
            if _at(s, cur, 4, ("JOSE",)) or _at(s, 0, 4, ("SAN ",)):
                if (cur == 0 and s[cur + 4] == " ") \
                        or _at(s, 0, 4, ("SAN ",)):
                    add("H")
                else:
                    add("J", "H")
                cur += 1
                continue
            if cur == 0 and not _at(s, cur, 4, ("JOSE",)):
                add("J", "A")  # Yankelovich/Jankelowicz
            else:
                # spanish pron. of e.g. 'bajador'
                if (_is_vowel(s, cur - 1) and not sg
                        and (s[cur + 1] == "A" or s[cur + 1] == "O")):
                    add("J", "H")
                else:
                    if cur == last:
                        add("J", "")
                    else:
                        if not _at(s, cur + 1, 1,
                                   ("L", "T", "K", "S", "N", "M", "B",
                                    "Z")) \
                                and not _at(s, cur - 1, 1,
                                            ("S", "K", "L")):
                            add("J")
            cur += 2 if s[cur + 1] == "J" else 1
            continue

        if c == "K":
            cur += 2 if s[cur + 1] == "K" else 1
            add("K")
            continue

        if c == "L":
            if s[cur + 1] == "L":
                # spanish e.g. 'cabrillo', 'gallegos'
                if ((cur == length - 3
                     and _at(s, cur - 1, 4, ("ILLO", "ILLA", "ALLE")))
                        or ((_at(s, last - 1, 2, ("AS", "OS"))
                             or _at(s, last, 1, ("A", "O")))
                            and _at(s, cur - 1, 4, ("ALLE",)))):
                    add("L", "")
                    cur += 2
                    continue
                cur += 2
            else:
                cur += 1
            add("L")
            continue

        if c == "M":
            if (_at(s, cur - 1, 3, ("UMB",))
                    and (cur + 1 == last
                         or _at(s, cur + 2, 2, ("ER",)))) \
                    or s[cur + 1] == "M":
                cur += 2
            else:
                cur += 1
            add("M")
            continue

        if c == "N":
            cur += 2 if s[cur + 1] == "N" else 1
            add("N")
            continue

        if c == "\xd1":  # Ñ
            cur += 1
            add("N")
            continue

        if c == "P":
            if s[cur + 1] == "H":
                add("F")
                cur += 2
                continue
            # also account for "campbell", "raspberry"
            cur += 2 if _at(s, cur + 1, 1, ("P", "B")) else 1
            add("P")
            continue

        if c == "Q":
            cur += 2 if s[cur + 1] == "Q" else 1
            add("K")
            continue

        if c == "R":
            # french e.g. 'rogier', but exclude 'hochmeier'
            if (cur == last and not sg
                    and _at(s, cur - 2, 2, ("IE",))
                    and not _at(s, cur - 4, 2, ("ME", "MA"))):
                add("", "R")
            else:
                add("R")
            cur += 2 if s[cur + 1] == "R" else 1
            continue

        if c == "S":
            # special cases 'island', 'isle', 'carlisle', 'carlysle'
            if _at(s, cur - 1, 3, ("ISL", "YSL")):
                cur += 1
                continue
            # special case 'sugar-'
            if cur == 0 and _at(s, cur, 5, ("SUGAR",)):
                add("X", "S")
                cur += 1
                continue
            if _at(s, cur, 2, ("SH",)):
                # germanic
                if _at(s, cur + 1, 4,
                       ("HEIM", "HOEK", "HOLM", "HOLZ")):
                    add("S")
                else:
                    add("X")
                cur += 2
                continue
            # italian & armenian
            if _at(s, cur, 3, ("SIO", "SIA")) or _at(s, cur, 4, ("SIAN",)):
                if not sg:
                    add("S", "X")
                else:
                    add("S")
                cur += 3
                continue
            # german & anglicisations, e.g. 'smith' match 'schmidt',
            # 'snider' match 'schneider'; also, -sz- in slavic language
            # although in hungarian it is pronounced 's'
            if (cur == 0 and _at(s, cur + 1, 1, ("M", "N", "L", "W"))) \
                    or _at(s, cur + 1, 1, ("Z",)):
                add("S", "X")
                if _at(s, cur + 1, 1, ("Z",)):
                    cur += 2
                else:
                    cur += 1
                continue
            if _at(s, cur, 2, ("SC",)):
                # Schlesinger's rule
                if s[cur + 2] == "H":
                    # dutch origin, e.g. 'school', 'schooner'
                    if _at(s, cur + 3, 2,
                           ("OO", "ER", "EN", "UY", "ED", "EM")):
                        # 'schermerhorn', 'schenker'
                        if _at(s, cur + 3, 2, ("ER", "EN")):
                            add("X", "SK")
                        else:
                            add("SK")
                        cur += 3
                        continue
                    else:
                        if (cur == 0 and not _is_vowel(s, 3)
                                and s[3] != "W"):
                            add("X", "S")
                        else:
                            add("X")
                        cur += 3
                        continue
                if _at(s, cur + 2, 1, ("I", "E", "Y")):
                    add("S")
                    cur += 3
                    continue
                add("SK")
                cur += 3
                continue
            # french e.g. 'resnais', 'artois'
            if cur == last and _at(s, cur - 2, 2, ("AI", "OI")):
                add("", "S")
            else:
                add("S")
            cur += 2 if _at(s, cur + 1, 1, ("S", "Z")) else 1
            continue

        if c == "T":
            if _at(s, cur, 4, ("TION",)):
                add("X")
                cur += 3
                continue
            if _at(s, cur, 3, ("TIA", "TCH")):
                add("X")
                cur += 3
                continue
            if _at(s, cur, 2, ("TH",)) or _at(s, cur, 3, ("TTH",)):
                # special case 'thomas', 'thames' or germanic
                if (_at(s, cur + 2, 2, ("OM", "AM"))
                        or _at(s, 0, 4, ("VAN ", "VON "))
                        or _at(s, 0, 3, ("SCH",))):
                    add("T")
                else:
                    add("0", "T")
                cur += 2
                continue
            cur += 2 if _at(s, cur + 1, 1, ("T", "D")) else 1
            add("T")
            continue

        if c == "V":
            cur += 2 if s[cur + 1] == "V" else 1
            add("F")
            continue

        if c == "W":
            # can also be in middle of word
            if _at(s, cur, 2, ("WR",)):
                add("R")
                cur += 2
                continue
            if cur == 0 and (_is_vowel(s, cur + 1)
                             or _at(s, cur, 2, ("WH",))):
                # Wasserman should match Vasserman
                if _is_vowel(s, cur + 1):
                    add("A", "F")
                else:
                    # need Uomo to match Womo
                    add("A")
            # Arnow should match Arnoff
            if ((cur == last and _is_vowel(s, cur - 1))
                    or _at(s, cur - 1, 5,
                           ("EWSKI", "EWSKY", "OWSKI", "OWSKY"))
                    or _at(s, 0, 3, ("SCH",))):
                add("", "F")
                cur += 1
                continue
            # polish e.g. 'filipowicz'
            if _at(s, cur, 4, ("WICZ", "WITZ")):
                add("TS", "FX")
                cur += 4
                continue
            # else skip it
            cur += 1
            continue

        if c == "X":
            # french e.g. breaux
            if not (cur == last
                    and (_at(s, cur - 3, 3, ("IAU", "EAU"))
                         or _at(s, cur - 2, 2, ("AU", "OU")))):
                add("KS")
            cur += 2 if _at(s, cur + 1, 1, ("C", "X")) else 1
            continue

        if c == "Z":
            # chinese pinyin e.g. 'zhao'
            if s[cur + 1] == "H":
                add("J")
                cur += 2
                continue
            elif (_at(s, cur + 1, 2, ("ZO", "ZI", "ZA"))
                  or (sg and cur > 0 and s[cur - 1] != "T")):
                add("S", "TS")
            else:
                add("S")
            cur += 2 if s[cur + 1] == "Z" else 1
            continue

        cur += 1

    return "".join(pri)[:max_len], "".join(sec)[:max_len]


def dm_code(word: str, max_len: int = 4) -> str:
    """Primary double-metaphone code (the match-pipeline hash — the
    reference indexes and expands with the primary only)."""
    return double_metaphone(word, max_len)[0]


def dm_codes(word: str, max_len: int = 4) -> tuple[str, str]:
    """Primary + secondary codes (reference: FT.DEBUG
    DUMP_PHONETIC_HASH, debug_commands.c:996)."""
    return double_metaphone(word, max_len)
