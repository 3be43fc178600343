"""X11 keysym database for key injection.

Role parity with the reference's ``server_keysym_map.py`` (1,537 LoC data
table mapping keysym → X key name).  Instead of a hand-maintained table we
assemble the map programmatically from the well-known X11 ``keysymdef.h``
ranges: Latin-1 keysyms are their own codepoints (0x20-0xFF), Unicode
keysyms are ``0x01000000 | codepoint``, and the function/TTY/keypad/modifier
blocks (0xFF00-0xFFFF) are enumerated below by name.

``keysym_to_name(ks)`` returns the X key name usable with ``xdotool key`` /
``XStringToKeysym``; ``keysym_to_char(ks)`` returns the printable character,
if any.
"""

from __future__ import annotations

from typing import Dict, Optional

# -- function / control keysym block (0xFF00-0xFFFF + misc) ------------------

_NAMED: Dict[int, str] = {
    0xFF08: "BackSpace",
    0xFF09: "Tab",
    0xFF0A: "Linefeed",
    0xFF0B: "Clear",
    0xFF0D: "Return",
    0xFF13: "Pause",
    0xFF14: "Scroll_Lock",
    0xFF15: "Sys_Req",
    0xFF1B: "Escape",
    0xFFFF: "Delete",
    # international
    0xFF20: "Multi_key",
    0xFF37: "Codeinput",
    0xFF3C: "SingleCandidate",
    0xFF3D: "MultipleCandidate",
    0xFF3E: "PreviousCandidate",
    # japanese
    0xFF21: "Kanji",
    0xFF22: "Muhenkan",
    0xFF23: "Henkan_Mode",
    0xFF24: "Romaji",
    0xFF25: "Hiragana",
    0xFF26: "Katakana",
    0xFF27: "Hiragana_Katakana",
    0xFF28: "Zenkaku",
    0xFF29: "Hankaku",
    0xFF2A: "Zenkaku_Hankaku",
    0xFF2B: "Touroku",
    0xFF2C: "Massyo",
    0xFF2D: "Kana_Lock",
    0xFF2E: "Kana_Shift",
    0xFF2F: "Eisu_Shift",
    0xFF30: "Eisu_toggle",
    # cursor
    0xFF50: "Home",
    0xFF51: "Left",
    0xFF52: "Up",
    0xFF53: "Right",
    0xFF54: "Down",
    0xFF55: "Prior",  # Page_Up
    0xFF56: "Next",   # Page_Down
    0xFF57: "End",
    0xFF58: "Begin",
    # misc functions
    0xFF60: "Select",
    0xFF61: "Print",
    0xFF62: "Execute",
    0xFF63: "Insert",
    0xFF65: "Undo",
    0xFF66: "Redo",
    0xFF67: "Menu",
    0xFF68: "Find",
    0xFF69: "Cancel",
    0xFF6A: "Help",
    0xFF6B: "Break",
    0xFF7E: "Mode_switch",
    0xFF7F: "Num_Lock",
    # keypad
    0xFF80: "KP_Space",
    0xFF89: "KP_Tab",
    0xFF8D: "KP_Enter",
    0xFF91: "KP_F1",
    0xFF92: "KP_F2",
    0xFF93: "KP_F3",
    0xFF94: "KP_F4",
    0xFF95: "KP_Home",
    0xFF96: "KP_Left",
    0xFF97: "KP_Up",
    0xFF98: "KP_Right",
    0xFF99: "KP_Down",
    0xFF9A: "KP_Prior",
    0xFF9B: "KP_Next",
    0xFF9C: "KP_End",
    0xFF9D: "KP_Begin",
    0xFF9E: "KP_Insert",
    0xFF9F: "KP_Delete",
    0xFFBD: "KP_Equal",
    0xFFAA: "KP_Multiply",
    0xFFAB: "KP_Add",
    0xFFAC: "KP_Separator",
    0xFFAD: "KP_Subtract",
    0xFFAE: "KP_Decimal",
    0xFFAF: "KP_Divide",
    # modifiers
    0xFFE1: "Shift_L",
    0xFFE2: "Shift_R",
    0xFFE3: "Control_L",
    0xFFE4: "Control_R",
    0xFFE5: "Caps_Lock",
    0xFFE6: "Shift_Lock",
    0xFFE7: "Meta_L",
    0xFFE8: "Meta_R",
    0xFFE9: "Alt_L",
    0xFFEA: "Alt_R",
    0xFFEB: "Super_L",
    0xFFEC: "Super_R",
    0xFFED: "Hyper_L",
    0xFFEE: "Hyper_R",
    # ISO extensions
    0xFE03: "ISO_Level3_Shift",
    0xFE04: "ISO_Level3_Latch",
    0xFE08: "ISO_Level5_Shift",
    0xFE20: "ISO_Left_Tab",
    0xFE50: "dead_grave",
    0xFE51: "dead_acute",
    0xFE52: "dead_circumflex",
    0xFE53: "dead_tilde",
    0xFE54: "dead_macron",
    0xFE55: "dead_breve",
    0xFE56: "dead_abovedot",
    0xFE57: "dead_diaeresis",
    0xFE58: "dead_abovering",
    0xFE59: "dead_doubleacute",
    0xFE5A: "dead_caron",
    0xFE5B: "dead_cedilla",
    0xFE5C: "dead_ogonek",
    0xFE5D: "dead_iota",
}

# F1-F35 (0xFFBE..0xFFE0)
for _i in range(35):
    _NAMED[0xFFBE + _i] = f"F{_i + 1}"
# KP_0..KP_9 (0xFFB0..0xFFB9)
for _i in range(10):
    _NAMED[0xFFB0 + _i] = f"KP_{_i}"

# XF86 multimedia keys commonly sent by browsers
_XF86: Dict[int, str] = {
    0x1008FF11: "XF86AudioLowerVolume",
    0x1008FF12: "XF86AudioMute",
    0x1008FF13: "XF86AudioRaiseVolume",
    0x1008FF14: "XF86AudioPlay",
    0x1008FF15: "XF86AudioStop",
    0x1008FF16: "XF86AudioPrev",
    0x1008FF17: "XF86AudioNext",
    0x1008FF18: "XF86HomePage",
    0x1008FF19: "XF86Mail",
    0x1008FF26: "XF86Back",
    0x1008FF27: "XF86Forward",
    0x1008FF2A: "XF86PowerOff",
    0x1008FF2F: "XF86Sleep",
    0x1008FF30: "XF86Favorites",
    0x1008FF31: "XF86AudioPause",
    0x1008FF41: "XF86Launch1",
    0x1008FF73: "XF86Reload",
    0x1008FF74: "XF86Search",
}
_NAMED.update(_XF86)

# Latin-1 punctuation/symbol key names (needed for xdotool by-name paths)
_LATIN1_NAMES: Dict[int, str] = {
    0x20: "space", 0x21: "exclam", 0x22: "quotedbl", 0x23: "numbersign",
    0x24: "dollar", 0x25: "percent", 0x26: "ampersand", 0x27: "apostrophe",
    0x28: "parenleft", 0x29: "parenright", 0x2A: "asterisk", 0x2B: "plus",
    0x2C: "comma", 0x2D: "minus", 0x2E: "period", 0x2F: "slash",
    0x3A: "colon", 0x3B: "semicolon", 0x3C: "less", 0x3D: "equal",
    0x3E: "greater", 0x3F: "question", 0x40: "at",
    0x5B: "bracketleft", 0x5C: "backslash", 0x5D: "bracketright",
    0x5E: "asciicircum", 0x5F: "underscore", 0x60: "grave",
    0x7B: "braceleft", 0x7C: "bar", 0x7D: "braceright", 0x7E: "asciitilde",
    0xA3: "sterling", 0xA7: "section", 0xB0: "degree", 0xB4: "acute",
    0xB5: "mu", 0xB7: "periodcentered", 0xBF: "questiondown",
    0xDF: "ssharp", 0xE9: "eacute", 0xE8: "egrave", 0xE7: "ccedilla",
    0xE0: "agrave", 0xF9: "ugrave",
}

MODIFIER_KEYSYMS = frozenset({
    0xFFE1, 0xFFE2,  # Shift
    0xFFE3, 0xFFE4,  # Control
    0xFFE5,          # Caps_Lock
    0xFFE7, 0xFFE8,  # Meta
    0xFFE9, 0xFFEA,  # Alt
    0xFFEB, 0xFFEC,  # Super
    0xFFED, 0xFFEE,  # Hyper
    0xFE03, 0xFE04, 0xFE08,  # ISO level shifts
})

#: names that act as shortcut modifiers for xdotool --clearmodifiers logic
SHORTCUT_MODIFIER_NAMES = frozenset({
    "Shift_L", "Shift_R", "Control_L", "Control_R",
    "Alt_L", "Alt_R", "Meta_L", "Meta_R", "Super_L", "Super_R",
})

UNICODE_KEYSYM_FLAG = 0x01000000


def is_unicode_keysym(keysym: int) -> bool:
    return (keysym & 0xFF000000) == UNICODE_KEYSYM_FLAG


def is_printable_keysym(keysym: int) -> bool:
    """Matches the reference's printable test (input_handler.py:1516)."""
    return (0x20 <= keysym <= 0xFF) or is_unicode_keysym(keysym)


def keysym_to_char(keysym: int) -> Optional[str]:
    """The character a keysym produces, or None for function keys."""
    if is_unicode_keysym(keysym):
        cp = keysym & 0x00FFFFFF
    elif 0x20 <= keysym <= 0xFF:
        cp = keysym
    else:
        return None
    try:
        return chr(cp)
    except ValueError:
        return None


def keysym_to_name(keysym: int) -> Optional[str]:
    """X key name for ``xdotool key`` / ``XStringToKeysym``.

    Unicode keysyms render as ``U<HEX>`` which xdotool accepts directly.
    """
    name = _NAMED.get(keysym)
    if name:
        return name
    if is_unicode_keysym(keysym):
        return f"U{keysym & 0x00FFFFFF:04X}"
    if 0x20 <= keysym <= 0xFF:
        name = _LATIN1_NAMES.get(keysym)
        if name:
            return name
        ch = chr(keysym)
        if ch.isalnum():
            return ch
        return f"U{keysym:04X}"
    return None
