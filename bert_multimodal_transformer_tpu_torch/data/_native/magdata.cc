// Native data-pipeline kernels: WordPiece tokenization + word→subword
// alignment.
//
// The reference's feature-conversion loop (multimodal_driver.py:82-140,
// the per-word tokenize/inversions hot loop at :89-103) is pure Python and
// CPU-bound at startup. This library implements the same algorithm in C++
// behind a C ABI consumed via ctypes (data/native.py); the Python
// WordPiece implementation (data/tokenization.py) remains the reference
// and the fallback.
//
// Scope: ASCII-path basic tokenization (lowercase, punctuation split,
// whitespace clean) + greedy longest-match WordPiece with "##"
// continuation pieces — byte-exact with the Python implementation for
// ASCII input; non-ASCII bytes are passed through as-is (MOSI/MOSEI
// transcripts are English).

#include <cctype>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Tokenizer {
  std::unordered_map<std::string, int> vocab;
  int unk_id = 0;
  bool lower = true;
  int max_chars_per_word = 100;
};

bool is_punct(unsigned char c) {
  if ((c >= 33 && c <= 47) || (c >= 58 && c <= 64) || (c >= 91 && c <= 96) ||
      (c >= 123 && c <= 126))
    return true;
  return false;
}

// Split one whitespace-free word into basic tokens (lowercase + punct
// split), ASCII path of BasicTokenizer.
void basic_split(const std::string& word, bool lower,
                 std::vector<std::string>* out) {
  std::string cur;
  for (unsigned char c : word) {
    if (c == 0 || c == ' ' || c == '\t' || c == '\n' || c == '\r') {
      if (!cur.empty()) { out->push_back(cur); cur.clear(); }
      continue;
    }
    unsigned char lc = (lower && c < 128) ? std::tolower(c) : c;
    if (c < 128 && is_punct(c)) {
      if (!cur.empty()) { out->push_back(cur); cur.clear(); }
      out->push_back(std::string(1, (char)lc));
    } else {
      cur.push_back((char)lc);
    }
  }
  if (!cur.empty()) out->push_back(cur);
}

// Greedy longest-match WordPiece on one basic token. Appends ids.
void wordpiece(const Tokenizer& tok, const std::string& word,
               std::vector<int>* ids) {
  if ((int)word.size() > tok.max_chars_per_word) {
    ids->push_back(tok.unk_id);
    return;
  }
  std::vector<int> pieces;
  size_t start = 0;
  const size_t n = word.size();
  while (start < n) {
    size_t end = n;
    int found = -1;
    while (start < end) {
      std::string piece = word.substr(start, end - start);
      if (start > 0) piece = "##" + piece;
      auto it = tok.vocab.find(piece);
      if (it != tok.vocab.end()) { found = it->second; break; }
      --end;
    }
    if (found < 0) {
      ids->push_back(tok.unk_id);
      return;
    }
    pieces.push_back(found);
    start = end;
  }
  ids->insert(ids->end(), pieces.begin(), pieces.end());
}

}  // namespace

extern "C" {

void* mag_tokenizer_new(const char** vocab_tokens, int n_tokens, int unk_id,
                        int do_lower_case) {
  auto* t = new Tokenizer();
  t->vocab.reserve(n_tokens * 2);
  for (int i = 0; i < n_tokens; ++i) t->vocab.emplace(vocab_tokens[i], i);
  t->unk_id = unk_id;
  t->lower = do_lower_case != 0;
  return t;
}

void mag_tokenizer_free(void* handle) {
  delete static_cast<Tokenizer*>(handle);
}

// Tokenize n_words words. Outputs token ids and per-token word indices
// (the reference's `inversions`, multimodal_driver.py:89-103) into
// caller-allocated buffers of capacity `cap`. Returns the total token
// count, or -1 if the buffers are too small (call again with a larger cap).
int mag_tokenize_words(void* handle, const char** words, int n_words,
                       int* out_ids, int* out_word_idx, int cap) {
  const Tokenizer& tok = *static_cast<Tokenizer*>(handle);
  std::vector<int> ids;
  std::vector<int> inv;
  std::vector<std::string> basic;
  ids.reserve(cap);
  inv.reserve(cap);
  for (int w = 0; w < n_words; ++w) {
    basic.clear();
    basic_split(words[w], tok.lower, &basic);
    for (const auto& b : basic) {
      size_t before = ids.size();
      wordpiece(tok, b, &ids);
      for (size_t k = before; k < ids.size(); ++k) inv.push_back(w);
    }
  }
  if ((int)ids.size() > cap) return -1;
  std::memcpy(out_ids, ids.data(), ids.size() * sizeof(int));
  std::memcpy(out_word_idx, inv.data(), inv.size() * sizeof(int));
  return (int)ids.size();
}

}  // extern "C"
