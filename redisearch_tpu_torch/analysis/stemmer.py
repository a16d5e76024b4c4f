# Copy of redisearch_tpu/analysis/stemmer.py: the port imports nothing of the JAX package.
"""Stemmer registry (reference: src/stemmer.c, src/language.c:22-52).

The reference bundles Snowball stemmers for ~30 languages.  Coverage here:
  * 15 languages (incl. english = Porter2) run nltk's generated Snowball
    implementations — the exact algorithms the reference vendors from
    deps/snowball;
  * the remaining 15 (snowball_ext.py: tagalog, indonesian/malay, hindi,
    nepali, irish, turkish, greek, catalan, basque, armenian, lithuanian,
    serbian, tamil, yiddish) are pure-Python ports of the published
    Snowball algorithms (fidelity notes per-language in that module);
  * chinese tokenizes via analysis/cjk.py and does not stem (reference
    parity: Friso segments, no stemmer);
  * unknown languages fall back to identity; the light suffix-strippers
    below remain only as the no-nltk fallback.

The stemmer interface mirrors the expander contract: stem(token) -> stem or
None if the stem equals the token (reference: StemmerExpander semantics,
src/ext/default.c).
"""

from __future__ import annotations

from typing import Callable, Optional

from .porter import porter_stem

# Language → ordered suffix list for the light stemmers.  Longest-match-first.
_LIGHT_SUFFIXES: dict[str, tuple[str, ...]] = {
    "french": ("issements", "issement", "atrices", "atrice", "ateurs", "ateur",
               "ements", "ement", "euses", "euse", "ances", "ance", "ences",
               "ence", "ables", "able", "istes", "iste", "eaux", "ions",
               "ment", "ées", "és", "er", "ez", "es", "e", "s"),
    "spanish": ("amientos", "imientos", "amiento", "imiento", "aciones",
                "uciones", "adoras", "adores", "ancias", "acion", "ución",
                "adora", "mente", "anza", "icos", "icas", "ismo", "able",
                "ible", "ista", "osos", "osas", "ados", "idas", "ando",
                "iendo", "ar", "er", "ir", "as", "os", "es", "a", "o", "e", "s"),
    "portuguese": ("amentos", "imentos", "amento", "imento", "adoras",
                   "adores", "aço~es", "mente", "idades", "idade", "ismos",
                   "istas", "osos", "osas", "ar", "er", "ir", "as", "os",
                   "es", "a", "o", "e", "s"),
    "italian": ("azioni", "azione", "amenti", "imenti", "amento", "imento",
                "mente", "atori", "atore", "anza", "anze", "ichi", "iche",
                "abili", "abile", "ibili", "ibile", "are", "ere", "ire",
                "ato", "ata", "ati", "ate", "i", "e", "a", "o"),
    "german": ("keiten", "keit", "heiten", "heit", "ungen", "ung", "isch",
               "lich", "end", "ern", "er", "en", "es", "em", "e", "s"),
    "dutch": ("heden", "heid", "ingen", "ing", "end", "ende", "en", "e", "s"),
    "swedish": ("heterna", "heten", "andet", "arnas", "ernas", "ornas",
                "arna", "erna", "orna", "ande", "ende", "aste", "arne",
                "are", "ade", "ad", "en", "ar", "er", "or", "a", "e", "s"),
    "norwegian": ("hetene", "heten", "endes", "ande", "ende", "edes", "enes",
                  "erte", "ede", "ane", "ene", "ens", "ers", "ets", "en",
                  "ar", "er", "as", "es", "et", "a", "e", "s"),
    "danish": ("erendes", "erende", "hedens", "ethed", "erede", "heden",
               "heder", "endes", "ernes", "erens", "erets", "ered", "ende",
               "erne", "eren", "erer", "eres", "eret", "hed", "ene", "ere",
               "ens", "ers", "ets", "en", "er", "es", "et", "e", "s"),
    "finnish": ("impia", "impien", "immat", "immi", "isten", "inen", "iset",
                "issa", "ista", "illa", "ilta", "ille", "ssa", "sta", "lla",
                "lta", "lle", "ksi", "ini", "isi", "mme", "nne", "nsa", "in",
                "it", "at", "an", "en", "a", "i", "t", "n"),
    "russian": ("иями", "иях", "ами", "ями", "ого", "его", "ому", "ему",
                "ыми", "ими", "ая", "яя", "ой", "ей", "ий", "ый", "ам", "ям",
                "ах", "ях", "ть", "ет", "ют", "ла", "ло", "ли", "ы", "и",
                "а", "я", "о", "е", "у", "ю", "ь"),
    "hungarian": ("okkal", "ekkel", "akkal", "eknek", "oknak", "ainak",
                  "einek", "ünk", "unk", "ban", "ben", "nak", "nek", "val",
                  "vel", "ból", "ből", "hoz", "hez", "ra", "re", "on", "en",
                  "ok", "ek", "ak", "at", "et", "ot", "k", "t"),
    "romanian": ("ibilitate", "abilitate", "ivitate", "icitate", "atoare",
                 "itoare", "ător", "itor", "area", "erea", "irea", "ate",
                 "ati", "ata", "ici", "ica", "uri", "ii", "ul", "ea", "le",
                 "a", "e", "i"),
    "turkish": ("larında", "lerinde", "larından", "lerinden", "ları",
                "leri", "ların", "lerin", "larda", "lerde", "lardan",
                "lerden", "lar", "ler", "ında", "inde", "dan", "den", "tan",
                "ten", "da", "de", "ta", "te", "ın", "in", "un", "ün",
                "ı", "i", "u", "ü"),
}

# Minimum stem length left behind by the light stemmers.
_MIN_STEM = 3

SUPPORTED_LANGUAGES = (
    "arabic", "armenian", "basque", "catalan", "danish", "dutch", "english",
    "finnish", "french", "german", "greek", "hindi", "hungarian",
    "indonesian", "irish", "italian", "lithuanian", "malay", "nepali",
    "norwegian", "portuguese", "romanian", "russian", "serbian", "spanish",
    "swedish", "tagalog", "tamil", "turkish", "yiddish", "chinese", "none",
)


def _light_stemmer(suffixes: tuple[str, ...]) -> Callable[[str], str]:
    def stem(word: str) -> str:
        for suf in suffixes:
            if word.endswith(suf) and len(word) - len(suf) >= _MIN_STEM:
                return word[: -len(suf)]
        return word

    return stem


# Languages with true Snowball implementations available (nltk ships
# generated Snowball code; same algorithms the reference bundles from
# deps/snowball).  Light stemmers remain the fallback for the rest.
# English is included: the reference default is Snowball english
# (Porter2, src/stemmer.c:70 sb_stemmer_new + language.c:96), NOT the
# 1980 Porter algorithm — their stems diverge (e.g. "generously" ->
# "generous" vs "gener").
_SNOWBALL_LANGS = frozenset((
    "arabic", "danish", "dutch", "english", "finnish", "french", "german",
    "hungarian", "italian", "norwegian", "portuguese", "romanian",
    "russian", "spanish", "swedish",
))
# Malay is not in Snowball; the reference backs it with indonesian
# (language.c:97-101) which nltk also lacks — light fallback applies.
_SNOWBALL_CACHE: dict = {}


def _snowball(lang: str) -> Optional[Callable[[str], str]]:
    fn = _SNOWBALL_CACHE.get(lang)
    if fn is not None:
        return fn
    try:
        import functools

        from nltk.stem.snowball import SnowballStemmer
        st = SnowballStemmer(lang)
    except Exception:
        return None
    fn = functools.lru_cache(maxsize=262144)(st.stem)
    _SNOWBALL_CACHE[lang] = fn
    return fn


class Stemmer:
    """Per-language stemmer handle (reference: NewStemmer, src/stemmer.c).

    Snowball languages (including english = Porter2) -> the exact
    Snowball algorithm; other supported names -> light suffix strippers;
    unknown -> identity.  Porter-1980 remains only as the no-nltk
    fallback for english."""

    def __init__(self, language: str = "english"):
        lang = (language or "english").lower()
        self.language = lang
        if lang in _SNOWBALL_LANGS:
            fn = _snowball(lang)
            if fn is not None:
                self._fn: Callable[[str], str] = fn
            elif lang == "english":
                self._fn = porter_stem
            else:
                self._fn = _light_stemmer(_LIGHT_SUFFIXES.get(lang, ()))
        else:
            from .snowball_ext import SNOWBALL_EXT
            ext = SNOWBALL_EXT.get(lang)
            if ext is not None:
                import functools
                self._fn = functools.lru_cache(maxsize=262144)(ext)
            elif lang in _LIGHT_SUFFIXES:
                self._fn = _light_stemmer(_LIGHT_SUFFIXES[lang])
            else:
                self._fn = lambda w: w

    def stem(self, token: str) -> Optional[str]:
        """Return the stem, or None if stemming changes nothing."""
        s = self._fn(token)
        return s if s != token else None


def is_supported_language(language: str) -> bool:
    return (language or "").lower() in SUPPORTED_LANGUAGES
